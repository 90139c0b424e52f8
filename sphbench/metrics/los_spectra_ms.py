"""los_spectra_ms: kernel #5, the absorption spectra, the self device time of
the span ``sightlines.spectra``, summed over the traced window, a product's
mean (ms); none where the program records no such span or no device
time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "sightlines.spectra")
