"""topk_merge_roofline: the top-k merge kernel's share of its roofline over
the drivers' merges in the window: each merges (r_block, s_block)
candidate scores into an (r_block, k) state, whose least time is its
bytes over the peak bandwidth (``work.merge_bytes``), over the device
time of the merge kernels in the trace, %."""
from portbench import work
from portbench.readers import TOPK_MERGE_KERNELS, roofline


def read(run):
    t, launches = run.trace, run.launches.get("topk_merge", 0)
    if t is None or not launches:
        return None
    secs, n = t.seconds_matching(TOPK_MERGE_KERNELS)
    cfg = run.config
    one, _ = work.bound_s(0.0, work.merge_bytes(cfg["r_block"], cfg["s_block"], cfg["k"]),
                          run.device_kind)
    return roofline(one * launches, secs) if n else None
