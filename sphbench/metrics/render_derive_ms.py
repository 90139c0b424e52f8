"""render_derive_ms: the render layer's ``derive`` phase (the weighted
means, on the host), ``MapStack.timings["derive"]`` summed over a product's
stacks, a product's mean (ms)."""


def read(run):
    if not any("derive" in t for t in run.timings):
        return None
    return 1e3 * sum(t.get("derive", 0.0) for t in run.timings) / len(run.timings)
