"""Chunked RWKV6 time mixing (WKV): the CUDA kernel's wrapper.

``wkv_cuda`` takes the arguments of the JAX package's ``wkv_pallas``:
r, k, v and lw (BH, T, K), u (BH, K) and the chunk.  T need not be a
multiple of the chunk: the kernel reads tokens past T as zeros, as the
reference's padding.  On CUDA tensors it launches the hand-written kernels
of ``../csrc/wkv.cu``, three a call: the chunk states (ltot and U_n =
k_carry^T v of every chunk, into scratch that the wrapper allocates), the
carry (an elementwise scan over the chunks that turns U_n into the state
before chunk n, in place) and the outputs (every chunk at once).  On CPU
tensors it runs the plain version (``ref.wkv_plain``).  Nothing falls
back: a CUDA tensor that the kernels cannot take raises.  The kernels
compute the forward only: with grad mode on and an input that requires
grad, the wrapper raises on either device; a model trains through the plain
route (``kernels=False``, ``models/rwkv6.py::_chunked_wkv``), as the
reference does.
``wkv_cuda.launches`` counts calls that launched, one a call.

On meta tensors (the dry run, ``launch/dryrun.py``) nothing runs: the
wrapper makes every check the card path makes and returns an empty output
of the right shape and dtype.  On every device an active op analysis
(``launch/op_analysis.py``) counts one launch a call with
:func:`wkv_work`'s FLOPs and bytes; ``launches`` counts only the card's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import KernelRefusal, analysed, check, launch, load, refuse_autograd
from repro_torch.kernels.wkv.ref import wkv_plain

HEAD_SIZES = (16, 32, 64)
CHUNKS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
KERNELS = ("wkv_state_kernel", "wkv_carry_kernel", "wkv_out_kernel")


def launch_shapes(bh: int, t: int, kk: int, chunk: int) -> dict:
    """{kernel: (CTAs, threads a CTA, dynamic shared memory bytes)} of one
    f32 call at these sizes, as the launcher of ``../csrc/wkv.cu`` sets them
    (the state and output kernels are persistent: as many CTAs as fit)."""
    fn = load("wkv", _ARGTYPES).wkv_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    vals = (ctypes.c_int * 9)()
    if fn(bh, t, kk, chunk, vals) != 0:
        raise ValueError(f"no wkv kernel for head size {kk} and chunk {chunk}")
    return {name: tuple(vals[3 * i:3 * i + 3]) for i, name in enumerate(KERNELS)}


def wkv_flops(bh: int, t: int, kk: int, chunk: int) -> float:
    """Per chunk and head: the strictly causal scores and their product
    with v (C(C-1)/2 pairs each), the state apply and the state update (C·K²)."""
    return bh * -(-t // chunk) * (2.0 * kk * chunk * (chunk - 1) + 4.0 * chunk * kk * kk)


def wkv_work(r: torch.Tensor, chunk: int):
    """(FLOPs, bytes) of one call: :func:`wkv_flops`, and r, k, v, lw and u
    read once and the output written once (the scratch not counted)."""
    bh, t, kk = r.shape
    return wkv_flops(bh, t, kk, chunk), 5 * r.numel() * r.element_size() + 4 * bh * kk


def _checked(r, k, v, lw, u, chunk, dev):
    """(BH, T, K) after every check the kernels make of their arguments."""
    if r.dim() != 3:
        raise ValueError("r, k, v and lw must be 3-d: (BH, T, K)")
    bh, t, kk = r.shape
    if kk not in HEAD_SIZES:
        raise KernelRefusal(f"head size {kk} is not one the kernel takes: {HEAD_SIZES}")
    if chunk not in CHUNKS:
        raise KernelRefusal(f"chunk {chunk} is not one the kernel takes: {CHUNKS}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; the kernel takes float32 or bfloat16")
    for name, x in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check(name, x, r.dtype, (bh, t, kk), dev)
    check("u", u, torch.float32, (bh, kk), dev)
    return bh, t, kk


def wkv_cuda(
    r: torch.Tensor,    # (BH, T, K) f32 or bf16
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,   # (BH, T, K) log decays, ≤ 0
    u: torch.Tensor,    # (BH, K) f32 per-head bonus
    chunk: int = 128,
) -> torch.Tensor:
    """(BH, T, K) outputs in r.dtype, computed in f32."""
    refuse_autograd("wkv_cuda", "_chunked_wkv", r, k, v, lw, u)
    if r.device.type == "cpu":
        with analysed("wkv", r.shape[0] * r.shape[1] > 0, wkv_work, r, chunk):
            return wkv_plain(r, k, v, lw, u, chunk=chunk)
    if r.device.type == "meta":
        bh, t, _ = _checked(r, k, v, lw, u, chunk, r.device)
        with analysed("wkv", bh * t > 0, wkv_work, r, chunk):
            return torch.empty(r.shape, dtype=r.dtype, device=r.device)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_cuda runs on cuda, cpu or meta tensors, got {r.device}")
    dev = r.device
    bh, t, kk = _checked(r, k, v, lw, u, chunk, dev)
    if any(x.data_ptr() % 16 for x in (r, k, v, lw, u)):
        raise ValueError("r, k, v, lw and u must start on a 16-byte boundary")

    with analysed("wkv", bh * t > 0, wkv_work, r, chunk):
        out = torch.empty_like(r)
        if bh * t == 0:
            return out
        n_chunks = -(-t // chunk)
        states = torch.empty((bh, n_chunks, kk, kk), dtype=torch.float32, device=dev)
        ltot = torch.empty((bh, n_chunks, kk), dtype=torch.float32, device=dev)
        launch("wkv", _ARGTYPES, dev,
               r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
               out.data_ptr(), states.data_ptr(), ltot.data_ptr(), _DTYPES[r.dtype], bh, t, kk,
               chunk)
        wkv_cuda.launches += 1
        return out


wkv_cuda.launches = 0
