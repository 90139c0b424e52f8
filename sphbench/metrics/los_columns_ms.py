"""los_columns_ms: kernel #4, the sightline columns, the self device time of
the span ``sightlines.columns``, summed over the traced window, a product's
mean (ms); none where the program records no such span or no device
time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "sightlines.columns")
