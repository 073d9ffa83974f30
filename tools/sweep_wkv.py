#!/usr/bin/env python3
"""Time variants of the WKV kernels (src/repro_torch/kernels/csrc/wkv.cu)
on one CUDA card.

    python3 tools/sweep_wkv.py [variant ...]

Copies wkv.cu and bf16_io.cuh once per variant into
build/sweep_wkv/<variant>/, applies the variant's regex edits, builds it
with the port's build module (kernels/_build.py, nvcc for sm_90a, -Xptxas
-v) and times wkv_cuda at rwkv6-3b's width in f32 (chip_smoke.py phase 8:
B 2, T 4096, H 40, K 64, chunk 128), in turns: every variant once, then
again in reverse order.  Each line gives ms a call (CUDA events) and the
device ms of each of the call's kernels (torch.profiler).

Two kinds of variant.  Candidates ("walk-unroll8", "state-cw4", ...)
change only how the kernels run; each is held bit for bit to the first
design (kernels/legacy.py::wkv_v1).  Diagnoses ("out-no-prod",
"state-no-copy", ...) drop one phase of one kernel to show what that
phase costs: their outputs are wrong by construction and are not checked.
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
sys.path.insert(0, str(ROOT))   # chip_smoke: cuda_ms, device_ms, ptxas_usage, wkv_inputs

WALK = r"(for \(int i = 0; i < )C(; \+\+i\) \{\s+(?:const float lwv|acc \+= ls))"


def loop(head, bound="0"):
    """A regex edit that sets the bound of the loop whose text starts with
    ``head`` (a regex with one group before the bound and one after)."""
    return head, r"\g<1>" + bound + r"\g<2>"


CANDIDATES = {
    "base": [],
    "walk-unroll8": [(WALK, r"#pragma unroll 8\n\g<1>C\g<2>")],
    "prod-unroll2": [(r"#pragma unroll 1(\s+for \(int c = 0; c < K; c \+= 4\))",
                      r"#pragma unroll 2\g<1>")],
    "intra-unroll2": [(r"#pragma unroll 1(\s+for \(int j0 = 0;)", r"#pragma unroll 2\g<1>")],
    "state-cw4": [(r"int CW = 2;", "int CW = 4;")],   # U in 4 x 4 blocks: half the threads work
}
DIAGNOSES = {   # each drops one phase of one kernel
    "out-no-walk": [loop(r"(for \(int i = 0; i < )C(; \+\+i\) \{\s+const float lwv)"),
                    loop(r"(i = tid - K; i < )C(;)")],
    "out-no-exps": [loop(r"(for \(int idx = tid; idx < )C \* K(; idx \+= NT\) \{  // in place)")],
    "out-no-prod": [loop(r"(for \(int c = 0; c < )K(; c \+= 4\) \{\s+float4 ra)")],
    "out-no-intra": [loop(r"(j0 < )last(;)")],
    "out-no-copy": [loop(r"(if \()g < n_work(\)\s+copy_tile)", "false"),
                    loop(r"(if \()g < n_work(\) \{\s+const size_t base)", "false")],
    "state-no-copy": [loop(r"(if \()g < n_work(\) \{\s+const int t0)", "false")],
    "state-no-walk": [loop(r"(for \(int i = 0; i < )C(; \+\+i\) \{\s+acc \+= ls)")],
    "state-no-prod": [loop(r"(for \(int i = 0; i < )C(; \+\+i\) \{\s+const float4 ka)")],
}
VARIANTS = {**CANDIDATES, **DIAGNOSES}
SOURCES = ("wkv.cu", "bf16_io.cuh")


def make_variant(name, edits):
    src = ROOT / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/sweep_wkv" / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in SOURCES:
        text = (src / f).read_text()
        if f == "wkv.cu":
            for pat, rep in edits:
                text, n = re.subn(pat, rep, text)
                if n == 0:
                    raise ValueError(f"variant {name}: {pat!r} not found in {f}")
        (out / f).write_text(text)
    return out


def use(build_mod, csrc):
    build_mod.CSRC = csrc
    build_mod.BUILD_DIR = csrc.parent / "lib"
    build_mod.load.cache_clear()


def build_all(build_mod, dirs):
    """One nvcc per variant, all at once, each into the library path that
    build_mod.build() looks for; {variant: ptxas log} of those that built."""
    running = {}
    for n, d in dirs.items():
        use(build_mod, d)
        lib = build_mod.BUILD_DIR / f"wkv_{build_mod._digest()}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        running[n] = (lib, subprocess.Popen(
            [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib), str(d / "wkv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for n, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{n}: build failed, dropped\n{log[:3000]}")
            continue
        lib.with_suffix(".log").write_text(log)
        logs[n] = log
    return logs


def main():
    if not torch.cuda.is_available():
        print("sweep_wkv: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import WKV_WIDTH, cuda_ms, device_ms, ptxas_usage, wkv_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.legacy import wkv_v1
    from repro_torch.kernels.wkv.kernel import wkv_cuda

    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    b, t, h, kk, chunk = WKV_WIDTH
    args = wkv_inputs(dev, (b * h, t, kk), (b * h, kk), -6.0, seed=3)
    want = wkv_v1(*args, chunk=chunk)   # built from the sources as they are
    v1_ms = cuda_ms(lambda: wkv_v1(*args, chunk=chunk), reps=10)
    print(f"first design (wkv_v1): {v1_ms:.3f} ms a call")

    dirs = {n: make_variant(n, VARIANTS[n]) for n in names}
    logs = build_all(_build, dirs)
    names = [n for n in names if n in logs]
    for n in names:
        for fn, (regs, st, ld) in sorted(ptxas_usage(logs[n]).items()):
            if f"ILi{chunk}ELi{kk}Ef" in fn or "carry" in fn:
                kernel = re.search(r"(wkv_\w+_kernel)", fn).group(1)
                print(f"{n}: {kernel}: {regs} registers, spill stores {st} B, loads {ld} B")
    for n in names + names[::-1]:
        use(_build, dirs[n])
        got = wkv_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        check = "bit-identical" if torch.equal(got, want) else "DIFFERS"
        if n in CANDIDATES:
            assert check == "bit-identical", f"{n} differs from the first design"
        else:
            check = "diagnosis, not checked"
        ms = cuda_ms(lambda: wkv_cuda(*args, chunk=chunk), reps=10)
        per = device_ms(lambda: wkv_cuda(*args, chunk=chunk), 3, "wkv_")
        print(f"{n}: {ms:.3f} ms a call ({check}); " + ", ".join(
            f"{key} {val:.4f}" for key, val in sorted(per.items())))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
