"""stack_ms: the host wall of the products completed in the window over
their count (ms). A product is one call of the entry, ending with its maps
on the host."""


def read(run):
    return 1e3 * sum(run.walls) / len(run.walls)
