#!/usr/bin/env python3
"""Time variants of flash_attn's f32 (3xTF32 tensor-core) kernel on one CUDA card.

    python3 tools/sweep_flash_f32.py [variant ...]

Builds each variant of src/repro_torch/kernels/csrc/flash_attn.cu (the
tile constants of flash_tf32::Cfg, or the hi/lo split, rewritten by the
regex edits below) into build/sweep_flash/<variant>/ as
tools/sweep_flash_bf16.py does, holds each to the plain version under
repro_torch.testing.flash_close and times flash_attention_cuda in f32 at
the two widths of chip_smoke.py phase 7 (qwen3-0.6b: B 2, S 4096, H 16,
KVH 8, hd 128, causal; recurrentgemma-2b: B 1, S 4096, H 10, KVH 1,
hd 256, window 2048), in turns: every variant once, then again in reverse
order, with the fp32-FMA first design (csrc/legacy/flash_attn_v1.cu) at
the start and the end.  Variants: the sources as they are ("base"); lo
rounded to tf32 (an add and a mask) before the mma instead of passed as
it is ("lornd"); hi rounded by cvt.rna.tf32.f32 instead of integer
rounding ("cvt"); a second barrier at the end of each kv tile
("twosync"); one m16 tile a warp ("mt1"); 32-key tiles at hd 128
("bk32"); 8 warps of one m16 tile at hd 128 too ("w8"); 4 warps at hd
256 ("w4").  Prints ptxas's registers and spills per
head width, ms per launch and TFLOP/s.
"""
import os
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))                 # chip_smoke
sys.path.insert(0, str(ROOT / "tools"))       # sweep_flash_bf16: make_variant, use

MT1 = (r"int MT = HD >= 256 \? 1 : 2;", "int MT = 1;")
W8 = (r"int WARPS = HD >= 256 \? 8 : 4;", "int WARPS = 8;")
W4 = (r"int WARPS = HD >= 256 \? 8 : 4;", "int WARPS = 4;")
BK32 = (r"int BK = HD >= 128 \? 16 : 32;", "int BK = HD >= 256 ? 16 : 32;")
LORND = (r"lo = __float_as_uint\(x - __uint_as_float\(hi\)\);", "lo = tf32(x - __uint_as_float(hi));")
TWOSYNC = (r"\n    }\n  }\n\n  // output tile", "\n    }\n    __syncthreads();\n  }\n\n  // output tile")
CVT = (r"return \(__float_as_uint\(x\) \+ 0x1000u\) & 0xffffe000u;",   # a callable: no escapes
       lambda m: 'unsigned y;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(y) : "f"(x));\n  return y;')
VARIANTS = {
    "base": [],
    "lornd": [LORND],
    "cvt": [CVT],
    "twosync": [TWOSYNC],
    "mt1": [MT1],
    "bk32": [BK32],
    "w8": [W8, MT1, BK32],
    "w4": [W4],
}


def main():
    if not torch.cuda.is_available():
        print("sweep_flash_f32: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import FLASH_WIDTHS, cuda_ms, flash_qkv, ptxas_usage
    from repro_torch.kernels.flash_attn.kernel import visible_pairs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attn.ops import heads_first
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.kernels.legacy import flash_attn_v1
    from repro_torch.testing import flash_close
    from sweep_flash_bf16 import make_variant, use

    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    assert "flash_attn_v1" in _build.build()   # the sources' own libraries: the first design
    sources = (_build.CSRC, _build.BUILD_DIR)

    def use_sources():
        _build.CSRC, _build.BUILD_DIR = sources
        _build.load.cache_clear()

    dirs = {n: make_variant(f"f32_{n}", VARIANTS[n]) for n in names}
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
            if "flash_tf32" in fn:
                hd = re.search(r"ILi(\d+)E", fn).group(1)
                print(f"{n}: hd {hd}: {regs} registers, spill stores {st} B, loads {ld} B")

    dev = torch.device("cuda")
    cases = {}
    for model, (b, s, h, kvh, hd, window) in FLASH_WIDTHS.items():
        q, k, v = (heads_first(x) for x in flash_qkv(dev, b, s, h, kvh, hd, seed=hd))
        kw = dict(causal=True, sm_scale=hd ** -0.5, window=window)
        want = flash_attention_plain(q, k, v, **kw)
        flops = 4.0 * hd * visible_pairs(s, s, True, window) * b * h
        cases[model] = (q, k, v, kw, want, flops)

    def first_design():
        line = []
        for model, (q, k, v, kw, want, flops) in cases.items():
            ms = cuda_ms(lambda: flash_attn_v1(q, k, v, **kw), reps=5)
            line.append(f"{model} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
        print("first design (fp32 FMAs): " + "; ".join(line))

    use_sources()
    first_design()
    for n in names + names[::-1]:
        use(_build, dirs[n])
        line = []
        for model, (q, k, v, kw, want, flops) in cases.items():
            try:
                _, used = flash_close(flash_attention_cuda(q, k, v, **kw), want)
            except (AssertionError, RuntimeError) as e:   # wrong, or refused at launch
                line.append(f"{model} FAILED ({e})")
                continue
            ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=10)
            line.append(f"{model} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, tol used "
                        f"{used:.3f})")
        print(f"{n}: " + "; ".join(line))
    use_sources()
    first_design()
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
