"""Fused tile-skipping score → streaming top-k: the CUDA kernel's wrapper.

``knn_topk_fused`` takes the same arrays as the JAX package's
``knn_topk_pallas`` (layout in that module's docstring) and returns
((NR, k) scores, (NR, k) ids, (nR, 1) MinPruneScore per R block).  On CUDA
tensors it launches the hand-written kernel of ``../csrc/knn_topk.cu``; on
CPU tensors it runs the plain version (``ref.knn_topk_plain``).  Nothing
falls back: a CUDA tensor that the kernel cannot take raises.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (``build/kernels/`` at the repository root) at its
first use, and again whenever the source's hash changes; it is loaded with
``ctypes``.  ``knn_topk_fused.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from repro_torch.kernels.knn_topk.ref import knn_topk_plain

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "knn_topk.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "kernels"
MAX_K = 128
MAX_BLOCK_R = 256
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the knn_topk kernel needs the CUDA toolkit")
    return str(path)


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel's library unless this source's build exists.

    Returns (library path, compiler log); the log is empty when the
    library was already built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"knn_topk_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.knn_topk_launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.knn_topk_launch.restype = ctypes.c_int
    lib.knn_topk_error_string.argtypes = [ctypes.c_int]
    lib.knn_topk_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def knn_topk_fused(
    r_tiles: torch.Tensor,      # (T+1, NR, tile) f32 — sentinel tile last, all zeros
    s_tiles: torch.Tensor,      # (T+1, NS, tile) f32
    active: torch.Tensor,       # (nR, nS, A) int32, ascending, sentinel T padding
    s_valid: torch.Tensor,      # (1, NS) int32
    s_ids: torch.Tensor,        # (1, NS) int32
    init_scores: torch.Tensor,  # (NR, k) f32
    init_ids: torch.Tensor,     # (NR, k) int32
    thr: torch.Tensor | None = None,       # (1, 1) f32 seed MinPruneScore
    nr_valid: torch.Tensor | None = None,  # (1,) int32 real R rows
    block_r: int = 256,
    block_s: int = 256,
):
    """((NR, k) scores, (NR, k) ids, (nR, 1) MinPruneScore per R block).
    NR % block_r == NS % block_s == 0 (the callers pad)."""
    if r_tiles.device.type == "cpu":
        return knn_topk_plain(r_tiles, s_tiles, active, s_valid, s_ids, init_scores,
                              init_ids, thr=thr, nr_valid=nr_valid,
                              block_r=block_r, block_s=block_s)
    if r_tiles.device.type != "cuda":
        raise ValueError(f"knn_topk_fused runs on cuda or cpu tensors, got {r_tiles.device}")
    dev = r_tiles.device
    t1, n_r, tile = r_tiles.shape
    n_s = s_tiles.shape[1]
    k = init_scores.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if not 1 <= block_r <= MAX_BLOCK_R or block_s < 1:
        raise ValueError(f"block_r must be in [1, {MAX_BLOCK_R}] and block_s >= 1")
    if n_r < 1 or n_r % block_r or n_s < 1 or n_s % block_s:
        raise ValueError(f"NR={n_r} and NS={n_s} must be positive multiples of "
                         f"block_r={block_r} and block_s={block_s}")
    n_rb, n_sb = n_r // block_r, n_s // block_s
    if thr is None:
        thr = torch.full((1, 1), float("-inf"), dtype=torch.float32, device=dev)
    if nr_valid is None:
        nr_valid = torch.full((1,), n_r, dtype=torch.int32, device=dev)
    _check("r_tiles", r_tiles, torch.float32, (t1, n_r, tile), dev)
    _check("s_tiles", s_tiles, torch.float32, (t1, n_s, tile), dev)
    if active.dim() != 3:
        raise ValueError("active must be (nR, nS, A)")
    _check("active", active, torch.int32, (n_rb, n_sb, active.shape[2]), dev)
    _check("s_valid", s_valid, torch.int32, (1, n_s), dev)
    _check("s_ids", s_ids, torch.int32, (1, n_s), dev)
    _check("init_scores", init_scores, torch.float32, (n_r, k), dev)
    _check("init_ids", init_ids, torch.int32, (n_r, k), dev)
    _check("thr", thr.reshape(1, 1), torch.float32, (1, 1), dev)
    _check("nr_valid", nr_valid.reshape(1), torch.int32, (1,), dev)

    lib = _library()
    out_s = torch.empty((n_r, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_r, k), dtype=torch.int32, device=dev)
    thr_out = torch.empty((n_rb, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_topk_launch(
            r_tiles.data_ptr(), s_tiles.data_ptr(), active.data_ptr(), s_valid.data_ptr(),
            s_ids.data_ptr(), init_scores.data_ptr(), init_ids.data_ptr(), thr.data_ptr(),
            nr_valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), thr_out.data_ptr(),
            t1, n_r, n_s, tile, n_rb, n_sb, active.shape[2], k, block_r, block_s, stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_topk launch failed: {lib.knn_topk_error_string(err).decode()}")
    knn_topk_fused.launches += 1
    return out_s, out_i, thr_out


knn_topk_fused.launches = 0
