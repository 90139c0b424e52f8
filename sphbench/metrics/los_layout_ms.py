"""los_layout_ms: the ray staging of the sightline products, the self device
time of the spans ``layout.rays`` (the columns' and the spectra's: the
particles' level and cell sort, the ray cells, the spectra's block
schedule), summed over the traced window, a product's mean (ms); none where
the program records no such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "layout.rays")
