"""The device's idle share of the profiled sub-window, in percent: one
minus the union of its operations' intervals over the sub-window."""


def read(record):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
