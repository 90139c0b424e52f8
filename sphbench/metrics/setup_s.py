"""setup_s: from the process's start to the first timed product (s):
imports, loading (or building) the program's libraries, drawing the inputs
from the seed on the card and one warm-up product."""


def read(run):
    return run.setup_s
