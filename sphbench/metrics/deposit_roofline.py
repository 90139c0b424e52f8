"""deposit_roofline: a product's least time on the card over its
device-busy time (%): the least time is the larger of its bytes over the
peak bandwidth and its FP32 operations over the peak rate
(``counting.least_seconds``, counted from the problem, not from any
kernel's launches); the busy time is the union of device intervals in the
traced window over the products completed."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    busy = run.trace.busy_s / len(run.walls)
    return 100.0 * run.work()["seconds"] / busy if busy > 0 else None
