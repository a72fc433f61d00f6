"""The whole update's share of the card's bf16 peak, in percent: the
model FLOPs of one update (``flops.py``, from the configuration's shapes)
times the updates of the traced run's window, over the window's seconds,
over 989 TFLOP/s, in every cell (a float32 configuration reads low, which
is what it makes of the chip)."""

from perfbench import peaks


def read(record):
    if not record.get("window_s"):
        return None
    rate = record["flops_per_update"] * record["updates"] / record["window_s"]
    return 100.0 * rate / peaks.BF16_FLOPS
