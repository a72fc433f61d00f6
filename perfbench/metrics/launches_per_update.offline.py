"""Device kernels per update in the traced run's profiled sub-window (the
captured trainer: sample -> update -> metric sums)."""


def read(record):
    trace = record.get("trace")
    if trace is None or not trace.kernels:
        return None
    return len(trace.kernels) / record["profile_steps"]
