"""Read the program's spans (``utils/profiling.py::spans``) after a traced
window, for the span metrics in ``metrics/``. A program without spans (one
older than them) gives nothing to read: every reader then returns None."""


def _spans(names) -> list:
    try:
        from astro_sph_tools_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return []
    return [s for s in spans() if s["name"] in names]


def self_ms(run, *names):
    """The self device time of the spans ``names``, summed over the window,
    a product's mean (ms); None where there is no such span, or a span has
    no device time (off a CUDA device)."""
    ms = [s["self_device_ms"] for s in _spans(names)]
    return sum(ms) / len(run.walls) if ms and None not in ms else None


def share_pct(name: str, part: str, whole: str = "particles"):
    """100 * the sum of the counter ``part`` over the sum of ``whole`` of the
    spans ``name`` in the window (%); None where there is no such span."""
    counts = [s["counts"] for s in _spans((name,))]
    total = sum(c.get(whole, 0) for c in counts)
    return 100.0 * sum(c.get(part, 0) for c in counts) / total if total else None
