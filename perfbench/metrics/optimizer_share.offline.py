"""The optimizer's and the soft-updates' share of an update's device time,
in percent: the kernels of ``torch._foreach_*`` (Adam's moments and step,
the targets' ``_foreach_lerp_``; the port's ``optim.py`` and
``utils/tree.py``), found by name, over the device's busy time."""

OPTIMIZER_KERNELS = ("multi_tensor_apply_kernel",)


def read(record):
    trace = record.get("trace")
    if trace is None or trace.busy_s <= 0:
        return None
    seconds = sum(s for name, s in trace.kernels if any(k in name for k in OPTIMIZER_KERNELS))
    if seconds <= 0:
        return None
    return 100.0 * seconds / trace.busy_s
