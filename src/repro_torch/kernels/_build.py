"""Build the port's CUDA kernels, load them with ``ctypes``, launch them.

Every ``csrc/*.cu`` (and ``csrc/legacy/*.cu``, earlier designs kept for
comparison) is compiled by its own ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/kernels/<name>_<hash>.so`` at the
repository root.  All sources are compiled together, in parallel, at the
first use of any kernel, and again whenever a file under ``csrc/``
changes: the hash covers every file there, headers included.  Each
library exports ``<name>_launch(..., stream)``, which returns a CUDA error
code, and ``<name>_error_string(code)``.

The LM kernels' wrappers also tell an active ATen-op analysis
(``launch/op_analysis.py``) what each call does: :func:`analysed` hides
the wrapper's own ATen ops from it and counts one launch of the kernel
with its FLOPs and bytes instead, on every device (the card, the CPU's
plain version, and meta tensors, where nothing runs).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelRefusal(ValueError):
    """An input a kernel cannot take, by one of its named limits (head
    width, chunk, grid size): raised on the card and on meta tensors alike."""


# the op analysis listening (launch/op_analysis.py), if any: they do not nest
RECORDERS: list = []
_IDLE = contextlib.nullcontext()


def analysed(name: str, launched: bool, work, *args):
    """A context for a wrapper's body: unseen by the op analysis listening,
    which then counts one launch of kernel ``name`` (if ``launched``) with
    the (FLOPs, bytes) that ``work(*args)`` gives.  When none listens it is
    a shared do-nothing context and ``work`` is not called."""
    if not RECORDERS:
        return _IDLE
    return _analysed(RECORDERS[-1], name, launched, work, args)


@contextlib.contextmanager
def _analysed(rec, name, launched, work, args):
    rec.paused += 1
    try:
        yield
    finally:
        rec.paused -= 1
    if launched:
        rec.kernel(name, *work(*args))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.rglob("*")):
        if f.is_file():
            h.update(str(f.relative_to(CSRC)).encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, tuple[pathlib.Path, str]]:
    """Compile every source whose library for this ``csrc/`` hash is missing.

    Returns {kernel name: (library path, compiler log)}; the log is kept
    beside the library (``.log``) and read back when the library was
    already built.  Raises if any compile fails."""
    digest = _digest()
    out, running = {}, []
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("legacy/*.cu")):
        lib = BUILD_DIR / f"{src.stem}_{digest}.so"
        if lib.exists():
            log = lib.with_suffix(".log")
            out[src.stem] = (lib, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
            out[src.stem] = (lib, log)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src.name}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, argtypes: tuple) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be;
    ``argtypes`` types its launch function, the stream argument excluded."""
    lib = ctypes.CDLL(str(build()[name][0]))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def launch(name: str, argtypes: tuple, device: torch.device, *args) -> None:
    """Launch ``<name>_launch(*args)`` on ``device``'s current stream; raise
    if the launch is refused.  Does not synchronise."""
    lib = load(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_autograd(op: str, plain: str, *inputs: torch.Tensor) -> None:
    """Raise when autograd would record ``op``: the kernels have no
    backward, so an output of theirs would leave its inputs without a
    gradient.  ``plain`` names the model's differentiable route."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        raise RuntimeError(
            f"{op} has no backward and an input requires grad; train through the plain "
            f"route ({plain}: build the model with kernels=False), or call it under "
            "torch.no_grad()")
