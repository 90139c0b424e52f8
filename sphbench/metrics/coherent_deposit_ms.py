"""coherent_deposit_ms: kernel #2, the self device time of the span
``deposit.coherent`` (the coherent pass, whole-row or window, and its
overlap-add), summed over the traced window, a product's mean (ms); none
where the program records no such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "deposit.coherent")
