"""Device milliseconds per update inside the device span ``optimizer``
(``optim.py:Adam.step`` and ``utils/tree.py:soft_update``, by their own
boundaries, whatever kernels implement them) in the marked sub-window: the
union of the operations between its marks, the marks left out, over the
sub-window's updates (``program_trace.py``)."""


def read(record):
    program = record.get("program_trace")
    if program is None or "optimizer" not in program.span_busy_s:
        return None
    return 1e3 * program.span_busy_s["optimizer"] / record["profile_steps"]
