"""The fused FB loss's share of its roofline, in percent: the least time
its work needs, summed over the ``fb_fwd_*`` and ``fb_bwd_*`` kernels'
launches, over their summed device time. The least time of one forward
and backward pass is the larger of its FLOPs at the card's TF32 rate
(the highest at which it multiplies float32 inputs; the kernels' 3xTF32
passes reach a third of it at most) and its bytes at the HBM's rate
(``flops.fused_fb_loss``)."""

from perfbench import flops, peaks


def read(record):
    trace, shape = record.get("trace"), record.get("fused_loss")
    if trace is None or shape is None:
        return None
    fwd = [s for name, s in trace.kernels if "fb_fwd" in name]
    bwd = [s for name, s in trace.kernels if "fb_bwd" in name]
    if not fwd or not bwd:
        return None
    work, moved = flops.fused_fb_loss(*shape)
    passes = record["profile_steps"]
    bound = passes * max(work / peaks.TF32_FLOPS, moved / peaks.HBM_BYTES)
    return 100.0 * bound / (sum(fwd) + sum(bwd))
