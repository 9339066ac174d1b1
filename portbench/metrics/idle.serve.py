"""idle.serve: the share of the traced window in which no device operation
ran (one minus the union of the kernels', copies' and sets' intervals in the
profiler's trace over the window), in %."""


def read(record):
    trace = record.get("trace", {})
    if not trace.get("window_s") or not trace.get("busy_s"):  # no device operation ran
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
