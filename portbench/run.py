"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix are read from ``BENCHMARK.json``; everything that belongs to one of
them is a file of its own, found by name:

* ``portbench/configs/<config>.json`` — the deployment's sizes;
* ``portbench/traffic/<traffic>.json`` — the mix's parameters, whose
  ``kind`` names the generator ``portbench/traffic/<kind>.py``;
* ``portbench/metrics/<metric>.py`` — one reader a per-layer metric; a
  ``<metric>.<variant>`` (the same quantity in cells that report another
  end-to-end metric) without a file of its own is read by ``<metric>.py``;
* ``portbench/limits/<cell>.json`` — the limit of each number compared.

A run makes R and S from ``--seed`` (``datagen.py``), builds and warms up
the program under test, ``repro_torch``, measures ``--seconds`` of
traffic, reads the device's peak memory, frees the program's state, and
then holds every answer of the window to the float64 reference
(``reference.py``).  With ``--trace 0`` it reports the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read under
``torch.profiler`` and the program's own spans and counters.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error are the same checks.  Without a
CUDA device, or with fewer than the cell asks for, it prints no result
and exits 2; if JAX or the JAX package has been imported, it exits 3.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# module names that the process of a run may not hold: JAX and the JAX
# package the port was made from (top-level names, compared whole)
BANNED = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The checkout's root (this package) and ``src`` (the program) first
    on the import path; a script's own directory off it."""
    sys.path[:] = [p for p in sys.path if not p or pathlib.Path(p).resolve() != HERE]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own ``build/kernels`` is there already)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def load_module(path: pathlib.Path):
    """A module of this benchmark loaded from its file (names may hold
    dots and dashes)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> pathlib.Path:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, or for a
    dotted name without a file of its own, the reader of the name with
    its last part cut off."""
    name = metric
    while not (HERE / "metrics" / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return HERE / "metrics" / f"{name}.py"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Run:
    """One run of one cell: what the traffic generator and the readers see."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
                 config: dict | None = None):
        import torch

        from portbench import datagen
        from portbench.devtrace import DeviceTrace

        cells = {w["name"]: w for w in bench["workloads"]}
        self.cell = cells[cell]
        self.seed, self.seconds, self.tracing = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[self.cell["config"]]
        self.config = config or load_json(ROOT / cfg_file)
        self.mix = load_json(HERE / "traffic" / f"{self.cell['traffic']}.json")
        self.kind = load_module(HERE / "traffic" / f"{self.mix['kind']}.py")
        self.limits = load_json(HERE / "limits" / f"{cell}.json")
        self.R, self.S = datagen.inputs(self.config, self.seed)
        self.trace = DeviceTrace() if self.tracing and self.device.type == "cuda" else None
        self.spans: list[dict] = []         # the program's spans in the window
        self.launches: dict[str, int] = {}  # kernel launches in the window
        self.counters: dict = {}            # what the traffic counted in the window

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _launch_counts() -> dict[str, int]:
        from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
        from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda

        return {"knn_topk": knn_topk_fused.launches, "topk_merge": topk_merge_cuda.launches}

    @contextlib.contextmanager
    def window(self):
        """The measured window: the device trace and the program's spans
        and launch counters cover exactly what runs inside it."""
        from repro_torch.obs.recorder import get_recorder

        rec = get_recorder()
        rec.clear()
        before = self._launch_counts()
        if self.trace is not None:
            self.trace.start()
        t0 = time.monotonic()
        yield self
        if self.trace is not None:
            self.trace.stop()
        else:
            self.sync()
        self.spans = [e for e in rec.events("span") if e["t_start"] >= t0]
        after = self._launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}


def _judge(run: Run, answers) -> dict:
    """The comparison's numbers over every answer of the window: the worst
    of each over all answers."""
    import numpy as np

    from portbench import reference

    (ri, rv, _), (si, sv, _) = run.R, run.S
    dim, k = run.config["dim"], run.config["k"]
    dev = run.device
    rows = np.unique(np.concatenate([a[0] for a in answers])) if answers else np.zeros(0, int)
    ref_s, _ = reference.topk((ri[rows], rv[rows]), (si, sv), k, dim, dev)
    pos = {int(r): i for i, r in enumerate(rows)}
    worst: dict = {}
    seen = set()
    for rws, ids, scores in answers:
        key = (rws.tobytes(), np.asarray(ids).tobytes(), np.asarray(scores).tobytes())
        if key in seen:         # the same answers again (a join repeated): judged once
            continue
        seen.add(key)
        at = np.array([pos[int(r)] for r in rws])
        id_s = reference.pair_scores((ri[rws], rv[rws]), (si, sv), ids, dim, dev)
        got = reference.compare(ids, scores, ref_s[at], id_s, len(si))
        for name, v in got.items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             config: dict | None = None, t_start: float | None = None):
    """One run of ``cell``: (the result object, the lines of checks)."""
    import torch

    from repro_torch.obs import recorder as obs_recorder
    from repro_torch.obs import trace as obs_trace

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(bench, cell, seed, seconds, trace, dev, config=config)
    obs_trace.set_tracing(run.tracing)
    if run.tracing:
        obs_recorder.set_recorder(obs_recorder.FlightRecorder(capacity=1 << 21))
    traffic = run.kind.Traffic(run)
    if run.trace is not None:
        run.trace.warm_up()
    run.sync()
    setup_s = time.perf_counter() - t_start
    print(f"{cell}: set-up {setup_s:.3f} s", file=sys.stderr)

    out = traffic.measure(run.seconds)
    run.counters = out["counters"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    if not run.tracing:
        have = dict(out["end_to_end"], setup_s=setup_s, device_peak_gib=peak / 2**30)
        for m in bench["end_to_end"]:
            if applies(m, cell):
                if m["name"] not in have:
                    raise RuntimeError(f"{cell} has no reading of {m['name']}")
                metrics[m["name"]] = {"value": have[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, cell):
                value = load_module(reader_path(m["name"])).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": run.device_kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()

    # the program's state goes before the reference runs on the device
    answers = out.pop("answers")
    traffic.release()
    del traffic, out["counters"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = _judge(run, answers)
    if "unanswered" in run.limits:
        numbers["unanswered"] = out.get("unanswered", 0)
    print(f"{cell}: reference and comparison {time.perf_counter() - t_ref:.3f} s over "
          f"{len(answers)} answer sets", file=sys.stderr)
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in run.limits.items()}
    result["correct"] = bool(answers) and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    _caches()
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    import repro_torch.core.engine  # noqa: F401  (the program under test: fail here without it)

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", t_start=_T0)
    found = banned_modules()
    if found:
        print(f"the run's process holds {', '.join(found)}: the benchmark may not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
