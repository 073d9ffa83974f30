"""join_mfu: the whole join's share of the chip's float32 peak: the FLOPs
that the inputs' sparse products need (``work.join_flops``) times the
joins finished, over the window's seconds and the peak, %."""
from portbench import work
from portbench.readers import join_flops


def read(run):
    c = run.counters
    if not c.get("joins") or c.get("elapsed_s", 0) <= 0:
        return None
    rate = join_flops(run) * c["joins"] / c["elapsed_s"]
    return 100.0 * rate / work.peak(run.device_kind)["fp32_flops"] or None
