"""The 3-D engine's contacts in percent of the environment's device time:
the busy time of the device span ``p3d_contacts`` (``envs/physics3d.py:step``,
each substep's contact state and forces) over that of ``env_step``, in the
marked cycle (``program_trace.py``)."""


def read(record):
    program = record.get("program_trace")
    if program is None or not program.span_busy_s.get("env_step"):
        return None
    if "p3d_contacts" not in program.span_busy_s:
        return None
    return 100.0 * program.span_busy_s["p3d_contacts"] / program.span_busy_s["env_step"]
