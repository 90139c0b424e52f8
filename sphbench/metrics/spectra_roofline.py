"""spectra_roofline: the spectra's least time on the card
(``reference/los_spectra.py::work``'s ``spectra``: their bytes over the
peak bandwidth or their FP32 operations over the peak rate, whichever is
longer, counted from the problem) over the self device time of kernel #5,
the span ``sightlines.spectra``, a product's mean (%). None where the
program records no such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    ms = self_ms(run, "sightlines.spectra")
    return 100.0 * run.work()["spectra"]["seconds"] / (ms / 1e3) if ms else None
