"""Device milliseconds per update inside the device span ``sample`` (the
replay sampler, ``OfflineTrainer._run_updates``) in the marked sub-window:
the union of the operations between its marks, the marks left out, over
the sub-window's updates (``program_trace.py``)."""


def read(record):
    program = record.get("program_trace")
    if program is None or "sample" not in program.span_busy_s:
        return None
    return 1e3 * program.span_busy_s["sample"] / record["profile_steps"]
