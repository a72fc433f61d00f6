"""Device milliseconds of the environment per control step: the busy time
of the device span ``env_step`` (``EpisodeCollector._step``'s ``env.step``:
all the environments at once, the 3-D engine's substeps among it) over the
collector's replays (the program whose outermost spans are ``act`` and
``env_step``) in the marked cycle (``program_trace.py``)."""


def read(record):
    program = record.get("program_trace")
    if program is None or "env_step" not in program.span_busy_s:
        return None
    replays = sum(v["replays"] for k, v in program.programs.items()
                  if "env_step" in k.split("+"))
    if replays <= 0:
        return None
    return 1e3 * program.span_busy_s["env_step"] / replays
