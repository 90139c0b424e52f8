"""render_io_ms: the render layer's ``io`` phase (reading the fields and
stacking the payloads), ``MapStack.timings["io"]``, a product's mean (ms)."""


def read(run):
    if not any("io" in t for t in run.timings):
        return None
    return 1e3 * sum(t.get("io", 0.0) for t in run.timings) / len(run.timings)
