"""The 3-D engine's solve in percent of the environment's device time: the
busy time of the device span ``p3d_solve`` (``envs/physics3d.py:step``, each
substep's joint torques, generalized forces, ``solve_ex`` and Euler update)
over that of ``env_step``, in the marked cycle (``program_trace.py``)."""


def read(record):
    program = record.get("program_trace")
    if program is None or not program.span_busy_s.get("env_step"):
        return None
    if "p3d_solve" not in program.span_busy_s:
        return None
    return 100.0 * program.span_busy_s["p3d_solve"] / program.span_busy_s["env_step"]
