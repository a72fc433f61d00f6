"""The environment's share of the collector's device time, in percent: the
device span ``env_step``'s busy time (``EpisodeCollector._step``'s
``env.step``) over the busy time of the collector's replays (the program
whose outermost spans are ``act`` and ``env_step``: the policy, the
environment and the buffer writes) in the marked cycle
(``program_trace.py``)."""


def read(record):
    program = record.get("program_trace")
    if program is None or "env_step" not in program.span_busy_s:
        return None
    collector = sum(v["busy_s"] for k, v in program.programs.items()
                    if "env_step" in k.split("+"))
    if collector <= 0:
        return None
    return 100.0 * program.span_busy_s["env_step"] / collector
