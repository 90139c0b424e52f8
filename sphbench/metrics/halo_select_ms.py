"""halo_select_ms: the halo render's f64 recentring and support cut,
``MapStack.timings`` ``recentre`` + ``select`` summed over a product's
haloes, a product's mean (ms); none where the product has no haloes."""


def read(run):
    if not any("select" in t for t in run.timings):
        return None
    return 1e3 * sum(t.get("recentre", 0.0) + t.get("select", 0.0) for t in run.timings) / len(run.timings)
