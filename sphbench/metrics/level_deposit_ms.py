"""level_deposit_ms: kernel #1's levels, the self device time of the spans
``deposit.levels`` (the sorted engine's level loop) and ``deposit.tail``
(the coherent engine's routed tail), with their overlap-adds, summed over
the traced window, a product's mean (ms); none where the program records
neither span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "deposit.levels", "deposit.tail")
