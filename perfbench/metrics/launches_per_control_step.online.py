"""Kernels per control step of the collector: the kernels of the
collector's graph replays in the traced run's unmarked profiled cycle, over
the number of those replays (one a control step; ``control_step_kernels``
of ``drivers/online_recipe.py`` finds them by their graph launch)."""


def read(record):
    return record.get("control_step_kernels")
