"""knn_topk_roofline: the fused score-and-select kernel's share of its
roofline: the least time that each launch's inputs need (an R block's
sparse products against all of S, ``work.block_bounds``) over the device
time of its kernels in the trace, summed over the window's launches, %."""
from portbench import work
from portbench.readers import KNN_TOPK_KERNELS, roofline


def read(run):
    t, launches = run.trace, run.launches.get("knn_topk", 0)
    if t is None or not launches:
        return None
    secs, n = t.seconds_matching(KNN_TOPK_KERNELS)
    cfg = run.config
    (ri, _, rn), (si, _, sn) = run.R, run.S
    per_join = work.block_bounds(ri, rn, si, sn, cfg["dim"], cfg["k"], cfg["r_block"],
                                 run.device_kind)
    mean_bound = sum(b for b, _ in per_join) / len(per_join)
    return roofline(mean_bound * launches, secs) if n else None
