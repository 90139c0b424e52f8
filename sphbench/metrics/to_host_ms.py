"""to_host_ms: the copy of the maps back to the host, the self device time
of the span ``render.to_host`` (the maps' ``.cpu()``), summed over the
traced window, a product's mean (ms); none where the program records no
such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "render.to_host")
