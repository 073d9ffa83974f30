#!/usr/bin/env python3
"""Time variants of flash_attn's bf16 tensor-core kernel on one CUDA card.

    python3 tools/sweep_flash_bf16.py [variant ...]

Copies src/repro_torch/kernels/csrc/flash_attn.cu and its headers once per
variant into build/sweep_flash/<variant>/, rewrites the tile constants of
flash_mma::Cfg that the variant names, builds it with the port's build
module (kernels/_build.py, nvcc for sm_90a, -Xptxas -v) and times
flash_attention_cuda in bf16 at the two widths of chip_smoke.py phase 7
(qwen3-0.6b: B 2, S 4096, H 16, KVH 8, hd 128, causal; recurrentgemma-2b:
B 1, S 4096, H 10, KVH 1, hd 256, window 2048), in turns: every variant
once, then again in reverse order.  Variants: the sources as they are
("base": two m16 tiles a warp below hd 256, 64-key tiles); one m16 tile a
warp everywhere ("mt1", the first tensor-core layout); 32-key tiles
everywhere ("bk32").  Each variant is held to the plain version under
repro_torch.testing.flash_close.  Prints ptxas's registers and spills per
head width, ms per launch and TFLOP/s.
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
sys.path.insert(0, str(ROOT))   # chip_smoke: ptxas_usage, FLASH_WIDTHS

VARIANTS = {
    "base": [],
    "mt1": [(r"int MT = HD == 256 \? 1 : 2;", "int MT = 1;")],
    "bk32": [(r"int BK = HD == 256 \? 32 : 64;", "int BK = 32;")],
}
SOURCES = ("flash_attn.cu", "flash_attn_simt.cuh", "bf16_io.cuh")


def make_variant(name, edits):
    src = ROOT / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/sweep_flash" / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in SOURCES:
        text = (src / f).read_text()
        if f == "flash_attn.cu":
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


def main():
    if not torch.cuda.is_available():
        print("sweep_flash_bf16: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import FLASH_WIDTHS, cuda_ms, flash_qkv, ptxas_usage
    from repro_torch.kernels.flash_attn.kernel import visible_pairs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attn.ops import heads_first
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.testing import flash_close

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
    for n in names:
        for fn, (regs, st, ld) in sorted(ptxas_usage(logs[n]["flash_attn"][1]).items()):
            if "flash_mma" in fn:
                hd = re.search(r"ILi(\d+)E", fn).group(1)
                print(f"{n}: hd {hd}: {regs} registers, spill stores {st} B, loads {ld} B")

    dev = torch.device("cuda")
    cases = {}
    for model, (b, s, h, kvh, hd, window) in FLASH_WIDTHS.items():
        q, k, v = (heads_first(x.bfloat16()) for x in flash_qkv(dev, b, s, h, kvh, hd, seed=hd))
        kw = dict(causal=True, sm_scale=hd ** -0.5, window=window)
        want = flash_attention_plain(q, k, v, **kw)
        flops = 4.0 * hd * visible_pairs(s, s, True, window) * b * h
        cases[model] = (q, k, v, kw, want, flops)
    for n in names + names[::-1]:
        use(_build, dirs[n])
        line = []
        for model, (q, k, v, kw, want, flops) in cases.items():
            _, used = flash_close(flash_attention_cuda(q, k, v, **kw), want)
            ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=10)
            line.append(f"{model} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, tol used "
                        f"{used:.3f})")
        print(f"{n}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
