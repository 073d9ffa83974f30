#!/usr/bin/env python3
"""Time variants of the shared fp32 tile mainloop on one CUDA card.

    python3 tools/sweep_score_tile.py [variant ...]

Copies src/repro_torch/kernels/csrc (knn_score.cu, knn_topk.cu and their
headers) once per variant into build/sweep/<variant>/, rewrites the
constants that the variant names, builds it with the port's build module
(kernels/_build.py, nvcc for sm_90a, -Xptxas -v) and times knn_score_cuda
and knn_topk_fused on one 2048-row R block of synthetic-10k against all of
S (the engine's shapes, as chip_smoke.py phases 1 and 4 run them), in
turns: every variant once, then again in reverse order.  Variants: the
sources as they are ("base"); knn_topk ranges of 1 or 2 column tiles
instead of split_ranges's choice; no L2 prefetch hint; 16-dim slices;
one CTA an SM (__launch_bounds__(256, 1)); and the cp.async row-major
mainloop of tools/score_tile_cpasync.cuh in place of score_tile.cuh.  Each variant's
outputs must equal the unchanged sources' bit for bit.  Prints ptxas's
registers and spills, ms per launch and TFLOP/s, and the device time of
knn_topk's two passes from torch.profiler.
"""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))   # chip_smoke.ptxas_usage
torch.backends.cuda.matmul.allow_tf32 = False

# variant: {file: [replacement file (optional), (regex, replacement), ...]}
DEPTH16 = [(r"kDepth = 8;", "kDepth = 16;")]
CPASYNC = "tools/score_tile_cpasync.cuh"   # a whole replacement of score_tile.cuh
ONE_CTA = [(r"__launch_bounds__\(kThreads, 2\)", "__launch_bounds__(kThreads, 1)")]


VARIANTS = {   # "run": column tiles a knn_topk range (kernel.split_ranges's choice if absent)
    "base": {},
    "run1": {"run": 1},
    "run2": {"run": 2},    # one S block of 256 columns a range
    "no-l2-hint": {"score_tile.cuh": [(r"ld\.global\.nc\.L2::256B\.v4\.f32",
                                       "ld.global.nc.v4.f32")]},
    "depth16": {"score_tile.cuh": DEPTH16},
    "one-cta-a-sm": {"knn_score.cu": ONE_CTA, "knn_topk.cu": ONE_CTA},
    "cpasync": {"score_tile.cuh": CPASYNC},
    "cpasync-one-cta-a-sm": {"score_tile.cuh": CPASYNC, "knn_score.cu": ONE_CTA,
                             "knn_topk.cu": ONE_CTA},
}
SOURCES = ("knn_score.cu", "knn_topk.cu", "score_tile.cuh", "topk_insert.cuh")


def make_variant(name, edits):
    src = ROOT / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/sweep" / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in SOURCES:
        edit = edits.get(f, [])
        edit = [edit] if isinstance(edit, str) else edit
        text = (src / f).read_text()
        if edit and isinstance(edit[0], str):   # a replacement file, then its edits
            text = (ROOT / edit[0]).read_text()
            edit = edit[1:]
        for pat, rep in edit:
            text, n = re.subn(pat, rep.replace("\\", "\\\\"), text)
            if n == 0:
                raise ValueError(f"variant {name}: {pat!r} not found in {f}")
        (out / f).write_text(text)
    return out


def use(build_mod, csrc):
    build_mod.CSRC = csrc
    build_mod.BUILD_DIR = csrc.parent / "lib"
    build_mod.load.cache_clear()


def main():
    if not torch.cuda.is_available():
        print("sweep_score_tile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn_score.kernel import knn_score_cuda
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.sparse.datagen import synthetic_sparse

    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dirs = {n: make_variant(n, VARIANTS[n]) for n in names}

    logs = {}
    for n in names:   # _build's globals name one variant at a time
        use(_build, dirs[n])
        try:
            logs[n] = _build.build()
        except RuntimeError as e:
            print(f"{n}: build failed, dropped\n{str(e)[:3000]}")
    names = [n for n in names if n in logs]
    from chip_smoke import ptxas_usage

    for n in names:
        for _, log in logs[n].values():
            for fn, (regs, st, ld) in sorted(ptxas_usage(log).items()):
                if "ILi1E" in fn or "score" in fn:
                    print(f"{n}: {fn}: {regs} registers, spill stores {st} B, loads {ld} B")

    dev = torch.device("cuda")
    S = synthetic_sparse(10_000, dim=10_000, nnz_mean=120, seed=1)
    R = synthetic_sparse(10_000, dim=10_000, nnz_mean=120, seed=0)
    spec = JoinSpec(k=5, algorithm="iib", r_block=2048, s_block=2048, tile=128, use_kernel=True)
    index = SparseKNNIndex.build(S, spec)
    args, kwargs, n_active = index.kernel_inputs(R.rows(0, 2048).to(dev),
                                                 R.indices[:2048].numpy(), 2048)
    br, bs = kwargs["block_r"], kwargs["block_s"]
    flops = 2.0 * br * bs * 128 * n_active
    score = lambda: knn_score_cuda(*args[:3], block_r=br, block_s=bs)   # noqa: E731
    topk = lambda: knn_topk_fused(*args, **kwargs)                      # noqa: E731

    def timed(fn, reps):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    import repro_torch.kernels.knn_topk.kernel as topk_kernel

    default_split = topk_kernel.split_ranges

    def use_variant(n):
        use(_build, dirs[n])
        run = VARIANTS[n].get("run")
        topk_kernel.split_ranges = default_split if run is None else (
            lambda n_rb, n_sb, block_r, block_s, n_sm: (-(-n_sb * -(-block_s // 128) // run), run))

    want = None
    for n in names + names[::-1]:
        use_variant(n)
        got = (score(), *topk())
        torch.cuda.synchronize()
        if want is None:
            want = got
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        s_ms, t_ms = timed(score, 10), timed(topk, 10)
        print(f"{n}: knn_score {s_ms:.3f} ms ({flops / s_ms / 1e9:.1f} TFLOP/s), knn_topk "
              f"{t_ms:.3f} ms ({flops / t_ms / 1e9:.1f} TFLOP/s), equal to the first: {same}")
        assert same, n

    from torch.profiler import ProfilerActivity, profile
    for n in names:
        use_variant(n)
        topk()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                topk()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "knn_topk" in ev.key:
                dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                print(f"{n}: profiler {ev.key[:60]}: {dt / 5 / 1e3:.3f} ms a launch "
                      f"({ev.count} calls)")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
