"""device_idle_pct: the share of the traced window in which no operation
ran on the device, 100 * (1 - union of device intervals / window) (%)."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
