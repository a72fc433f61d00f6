"""Device idle milliseconds per update inside the captured update's
replays, each replay from its first to its last device operation, in the
marked sub-window (``program_trace.py``): the gaps between the kernels of
one graph launch."""


def read(record):
    program = record.get("program_trace")
    if program is None or not program.replays:
        return None
    return 1e3 * program.replay_gap_s / record["profile_steps"]
