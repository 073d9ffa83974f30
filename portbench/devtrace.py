"""The device's trace over a measured window, and its reduction.

``torch.profiler`` with CUDA activity alone (CUPTI) records every
operation on the card and every CUDA call of the host; the host's ATen
ops are not recorded, since recording them slows a join's host side by
a quarter and so inflates the idle share it reads.  :class:`DeviceTrace`
keeps, from the trace, what the per-layer readers and the result line
need:

* the device's busy seconds: the union of the intervals in which any
  kernel, copy or fill ran;
* device seconds by operation name, for a reader's pattern and for the
  ten operations that took most time;
* the idle gaps: the stretches of the window in which nothing ran on the
  device, each named by the CUDA call the host was in at its middle, or
  as host code between CUDA calls.
"""
from __future__ import annotations

import re
import sys
import time
import warnings
from collections import defaultdict

import numpy as np

BACK_SCAN = 64           # host ops looked at before a gap's middle
NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


class DeviceTrace:
    """Profile the device between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.by_name: dict[str, float] = {}
        self.count_by_name: dict[str, int] = {}
        self.gaps: dict[str, float] = {}

    @staticmethod
    def warm_up() -> None:
        """Start and stop the profiler once, so that CUPTI's set-up falls
        outside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            self._prof.start()
        self._t0_ns = time.time_ns()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        t1_ns = time.time_ns()
        t = time.perf_counter()
        self._prof.stop()
        t_stop = time.perf_counter() - t
        events = self._events()
        t_read = time.perf_counter() - t - t_stop
        self._reduce(events, self._t0_ns, t1_ns)
        print(f"device trace: {len(events[0])} device and {len(events[1])} host events; stop "
              f"{t_stop:.2f} s, read {t_read:.2f} s, reduce "
              f"{time.perf_counter() - t - t_stop - t_read:.2f} s", file=sys.stderr)
        self._prof = None

    def _events(self):
        """(device intervals [(name, start_ns, end_ns)], host intervals) of
        the trace, read from the profiler's raw results."""
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            if e.device_type() != cuda:
                host.append(item)
            elif not e.is_user_annotation():        # a span on the device's timeline
                dev.append(item)
        return dev, host

    def _reduce(self, events, t0_ns: int, t1_ns: int) -> None:
        dev, host = events
        by_name, count = defaultdict(float), defaultdict(int)
        for name, s, e in dev:
            by_name[name] += (e - s) * 1e-9
            count[name] += 1
        self.by_name, self.count_by_name = dict(by_name), dict(count)
        if not dev:
            self.busy_s, self.gaps = 0.0, {}
            return
        iv = np.array([(s, e) for _, s, e in dev], np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        merged = []
        cur_s, cur_e = int(iv[0, 0]), int(iv[0, 1])
        for s, e in iv[1:]:
            if s > cur_e:
                merged.append((cur_s, cur_e))
                cur_s, cur_e = int(s), int(e)
            else:
                cur_e = max(cur_e, int(e))
        merged.append((cur_s, cur_e))
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        lo, hi = min(t0_ns, merged[0][0]), max(t1_ns, merged[-1][1])
        edges = [lo] + [x for se in merged for x in se] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.gaps = self._label(gaps, host)

    @staticmethod
    def _label(gaps, host) -> dict[str, float]:
        """Seconds of idle gap by the innermost host event running at each
        gap's middle (of those that started before it, the latest that has
        not ended)."""
        out = defaultdict(float)
        if not gaps:
            return {}
        g = np.array(gaps, np.int64)
        mid, secs = (g[:, 0] + g[:, 1]) // 2, (g[:, 1] - g[:, 0]) * 1e-9
        label = np.full(len(g), -1)
        if host:
            order = sorted(range(len(host)), key=lambda i: host[i][1])
            st = np.array([host[i][1] for i in order], np.int64)
            en = np.array([host[i][2] for i in order], np.int64)
            j = np.searchsorted(st, mid, side="right") - 1
            todo = np.arange(len(g))
            for _ in range(BACK_SCAN):
                jj = j[todo]
                ok = jj >= 0
                hit = np.zeros(len(todo), bool)
                hit[ok] = en[jj[ok]] >= mid[todo[ok]]
                label[todo[hit]] = np.asarray(order)[jj[hit]]
                todo = todo[~hit & ok]
                if not len(todo):
                    break
                j[todo] -= 1
        for lab, t in zip(label, secs):
            out[host[lab][0] if lab >= 0 else "host code between CUDA calls"] += float(t)
        return dict(out)

    # -- what readers ask ------------------------------------------------------

    def seconds_matching(self, pattern: str) -> tuple[float, int]:
        """(device seconds, operations) of the operations whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        secs = count = 0
        for name, t in self.by_name.items():
            if rx.search(name):
                secs += t
                count += self.count_by_name[name]
        return secs, count

    def breakdown(self) -> dict:
        """The result line's ``breakdown``: the ten device operations that
        took most time, and the ten largest sums of idle gaps by host call."""
        ops = sorted(self.by_name.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[_short(n), t] for n, t in ops],
                "idle_gaps": [[_short(n), t] for n, t in gaps]}
