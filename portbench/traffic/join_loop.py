"""Traffic kind ``join_loop``: whole joins of R against S, back to back.

A closed loop with one caller: a batch job that joins its R against an
index of S built once (``SparseKNNIndex.build`` + ``query``).  The next
join starts when the last one has answered; the join in flight when the
window's seconds have passed is finished.

Mix parameters (``traffic/<name>.json``):

* ``spec`` — the ``JoinSpec`` fields besides the configuration's (k,
  tile, r_block, s_block): ``algorithm`` and ``use_kernel``;
* ``warm_rows`` — R rows of the set-up's warm-up query (``null``: all of
  R); every R block is padded to ``r_block`` rows, so one block warms
  every shape a join uses.

End-to-end: R rows answered over the time from the window's start to
the last answer.
"""
from __future__ import annotations

import sys
import time

import numpy as np


def compared_rows(run, seconds: float):
    """The R rows whose answers a run of ``seconds`` compares: all of R."""
    return np.arange(len(run.R[0]))


class Traffic:
    def __init__(self, run):
        from repro_torch.core.engine import JoinSpec, SparseKNNIndex
        from repro_torch.sparse.format import from_arrays

        cfg, mix = run.config, run.mix
        self.run = run
        dim = cfg["dim"]
        (ri, rv, rn), (si, sv, sn) = run.R, run.S
        self.R = from_arrays(ri, rv, rn, dim)
        spec = JoinSpec(k=cfg["k"], tile=cfg["tile"], r_block=cfg["r_block"],
                        s_block=cfg["s_block"], **mix["spec"])
        self.index = SparseKNNIndex.build(from_arrays(si, sv, sn, dim), spec, device=run.device)
        warm = mix.get("warm_rows") or len(ri)
        self.index.query(self.R.rows(0, min(warm, len(ri))))
        run.sync()

    def measure(self, seconds: float) -> dict:
        from repro_torch.core.engine import JoinStats

        run, index, R = self.run, self.index, self.R
        stats = JoinStats()
        results, ends = [], []
        with run.window():
            cpu0 = time.process_time()
            t0 = time.perf_counter()
            while True:
                res = index.query(R, stats=stats)
                run.sync()
                results.append(res)
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            elapsed = time.perf_counter() - t0
            cpu_s = time.process_time() - cpu0
        _print_window(ends, cpu_s)
        n_r = R.num_vectors
        joins = len(results)
        rows = np.arange(n_r)
        counters = {
            "joins": joins,
            "r_blocks": -(-n_r // index.spec.r_block),
            "elapsed_s": elapsed,
            "stats": stats,
            # IIIB's threshold-free superset index: its list entries a block
            "superset_entries": sum(b.list_total for b in index._blocks),
        }
        answers = [(rows, r.ids.cpu().numpy(), r.scores.cpu().numpy()) for r in results]
        return {
            "end_to_end": {"join_rows_per_s": joins * n_r / elapsed},
            "attempted": joins * n_r,
            "failed": 0,
            "counters": counters,
            "answers": answers,
        }

    def release(self) -> None:
        self.index = None


def _print_window(ends, cpu_s: float) -> None:
    """One line on standard error of how steady the window ran: each
    join's seconds, and the process's CPU seconds meanwhile."""
    durs = np.diff(np.concatenate([[0.0], ends]))
    print(f"window: {len(durs)} joins over {ends[-1]:.3f} s, a join min {durs.min():.4f} "
          f"median {np.median(durs):.4f} p90 {np.percentile(durs, 90):.4f} max {durs.max():.4f} s; "
          f"host CPU {cpu_s:.3f} s", file=sys.stderr)
