"""Seconds of set-up spent building captured programs: the summed seconds
of the capture records (``trace.captures()``: each ``CapturedProgram``
from its first warm-up run to the end of its capture) made in set-up."""


def read(record):
    captures = record.get("captures")
    if not captures:
        return None
    return sum(c.seconds for c in captures)
