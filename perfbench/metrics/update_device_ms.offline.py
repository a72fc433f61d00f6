"""Device milliseconds per update: the union of the device's operation
intervals in the profiled sub-window over its updates."""


def read(record):
    trace = record.get("trace")
    if trace is None or trace.busy_s <= 0:
        return None
    return 1e3 * trace.busy_s / record["profile_steps"]
