"""Batched serving driver: continuous-batching decode loop with prefill (the
JAX package's ``launch/serve.py``).

Requests enter a queue, get prefilled into free cache slots, and decode
proceeds slot by slot every step (slots finished on max-len are
immediately refillable — continuous batching).  Every model family is
served: dense, moe, ssm, hybrid, and vlm and audio with the reference's
stub patches and frames (zeros).  The model runs on the card unless the
caller names another device: on CUDA every attention (self, local, cross,
encoder) runs the flash attention kernel and rwkv6's chunked time mix the
WKV kernel.

Over a mesh of more than one position the slots split over the DP
positions in contiguous blocks, as ``batch_spec`` splits the batch axis:
slot ``s``'s cache lives on its data row's device (where ``cache_spec``
puts a serving cache's batch axis), and the row serves from a copy of the
model gathered once at construction (a device that already holds it takes
no second one).  A slot runs the same shapes and code as on one device,
so its tokens are the one-device server's.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 8 --batch 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import canonical, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.placement import positions_along, replicate
from repro_torch.launch.sharding import batch_spec
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_admit: Optional[float] = None     # monotonic, set on slot admission
    t_finish: Optional[float] = None


def slot_devices(mesh, batch: int) -> List[torch.device]:
    """Each slot's device: the slots split over the positions that
    ``batch_spec`` gives a batch axis of ``batch`` rows, in contiguous
    blocks (all on position 0 where the spec leaves the axis whole)."""
    entry = batch_spec((batch,), mesh)[0]
    names = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    flat = mesh.devices.reshape(-1)
    rows = [canonical(flat[p]) for p in positions_along(mesh, names)]
    per = batch // len(rows)
    return [rows[s // per] for s in range(batch)]


class Server:
    """Slot-based continuous batching over a fixed decode batch.

    The model is built on ``device`` (CUDA unless named; a given ``mesh``
    names it instead: its first position's) from
    ``torch.Generator(device).manual_seed(seed)``, unless ``params`` (a
    model, e.g. from ``models/convert.py``, on that device) is given.  Over
    a larger mesh each slot serves on its data row's device (the module
    doc)."""

    def __init__(self, cfg, batch: int, max_seq: int, mesh=None, seed: int = 0,
                 device=None, params: Optional[M.LM] = None):
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        if mesh is None:
            self.device = canonical(resolve_device(device))
            mesh = make_host_mesh(1, 1, devices=[self.device])
        else:
            self.device = canonical(resolve_device(mesh.devices.reshape(-1)[0]))
        self.mesh = mesh
        if params is None:
            params = M.init_params(torch.Generator(self.device).manual_seed(seed), cfg)
        elif canonical(params.device) != self.device:
            raise ValueError(f"params are on {params.device}, the server on {self.device}")
        self.params = params
        self.slot_device = slot_devices(mesh, batch)
        # one copy of the model a row device, gathered once
        self.row_params = {self.device: params}
        for dev in self.slot_device:
            if dev not in self.row_params:
                self.row_params[dev] = replicate(params, dev)
        self.prefill = make_prefill_step(cfg, self.mesh)
        self.decode = make_decode_step(cfg, self.mesh)
        # one cache per slot (batch=1) so prefill shapes are slot-local
        self.slot_cache = [
            M.make_serve_cache(cfg, 1, max_seq, device=dev) for dev in self.slot_device
        ]
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.slot_pos = np.zeros(batch, np.int32)
        self.slot_tok = np.zeros((batch, 1), np.int32)
        self.finished: List[Request] = []

    def _on_device(self, device=None):
        """The slot's card as the current device: ``step`` may run on a
        watchdog thread (``runtime/fault.py::with_timeout``)."""
        device = device or self.device
        if device.type == "cuda":
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    def _stub_batch(self, tokens):
        """The prompt with the family's stub inputs: zero frames (B,
        encoder_seq, d) for audio, zero patches (B, num_patches, d) for vlm."""
        batch = {"tokens": tokens}
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros((tokens.shape[0], self.cfg.encoder_seq,
                                           self.cfg.d_model), device=tokens.device)
        if self.cfg.family == "vlm":
            batch["patches"] = torch.zeros((tokens.shape[0], self.cfg.num_patches,
                                            self.cfg.d_model), device=tokens.device)
        return batch

    def admit(self, req: Request) -> bool:
        for s in range(self.batch):
            if self.slot_req[s] is None:
                req.t_admit = time.monotonic()
                dev = self.slot_device[s]
                prompt = torch.as_tensor(req.prompt[None, :].astype(np.int32), device=dev)
                with self._on_device(dev):
                    logits, cache = self.prefill(self.row_params[dev], self._stub_batch(prompt),
                                                 self.slot_cache[s])
                    nxt = int(torch.argmax(logits[0, -1]))
                self.slot_cache[s] = cache
                self.slot_req[s] = req
                self.slot_pos[s] = len(req.prompt)
                req.out.append(nxt)
                self.slot_tok[s, 0] = nxt
                if len(req.out) >= req.max_new:
                    self._finish(s, req)
                return True
        return False

    def _finish(self, s: int, req: Request):
        req.done = True
        req.t_finish = time.monotonic()
        self.slot_req[s] = None  # slot freed: continuous batching
        self.finished.append(req)

    def latency_summary(self) -> dict:
        """p50/p99 admit→finish latency (ms) over completed requests —
        the same percentile definition the query-serving front-end
        (repro_torch.serve.metrics) reports."""
        from repro_torch.serve.metrics import percentiles

        lat = [
            r.t_finish - r.t_admit
            for r in self.finished
            if r.t_admit is not None and r.t_finish is not None
        ]
        pct = percentiles(lat)
        return {
            "p50_ms": None if pct["p50"] is None else round(pct["p50"] * 1e3, 3),
            "p99_ms": None if pct["p99"] is None else round(pct["p99"] * 1e3, 3),
        }

    def step(self):
        """One decode step for every occupied slot."""
        for s in range(self.batch):
            req = self.slot_req[s]
            if req is None:
                continue
            dev = self.slot_device[s]
            with self._on_device(dev):
                logits, cache = self.decode(
                    self.row_params[dev],
                    torch.as_tensor(self.slot_tok[s : s + 1], device=dev),
                    self.slot_cache[s],
                    int(self.slot_pos[s]),
                )
                nxt = int(torch.argmax(logits[0, -1]))
            self.slot_cache[s] = cache
            self.slot_pos[s] += 1
            req.out.append(nxt)
            self.slot_tok[s, 0] = nxt
            if len(req.out) >= req.max_new or self.slot_pos[s] >= self.max_seq - 1:
                self._finish(s, req)

    def occupancy(self) -> int:
        return sum(r is not None for r in self.slot_req)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-timeout", type=float, default=None,
                    help="per-decode-step watchdog in seconds (one retry)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    pending = collections.deque(
        Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                args.max_new)
        for i in range(args.requests)
    )
    srv = Server(cfg, args.batch, args.max_seq, device=args.device)

    from repro_torch.runtime.fault import with_timeout
    from repro_torch.serve.metrics import ServeMetrics

    # fault-path counters live in a registry-backed ServeMetrics: the
    # printed "faults" section IS metrics.faults() — one schema (and one
    # storage) shared with the query-serving front-end, no hand mirror
    metrics = ServeMetrics()
    t0 = time.time()
    steps = 0
    while pending or srv.occupancy():
        while pending and srv.admit(pending[0]):
            pending.popleft()
        if pending:
            metrics.on_reject()     # admission bounce: no free slot
        try:
            with_timeout(srv.step, args.step_timeout)
        except TimeoutError:
            metrics.timeouts += 1   # step watchdog fired
            metrics.retries += 1
            with_timeout(srv.step, args.step_timeout)  # one retry, then raise
        steps += 1
        if steps > 10_000:
            raise RuntimeError("serving loop did not converge")
    dt = time.time() - t0
    finished = srv.finished
    tokens_per_request = {str(r.rid): len(r.out) for r in sorted(finished, key=lambda r: r.rid)}
    total_tokens = sum(tokens_per_request.values())
    print(json.dumps({
        "arch": cfg.name, "requests": args.requests, "completed": len(finished),
        "decode_steps": steps, "wall_s": round(dt, 2),
        "tok_per_s": round(total_tokens / max(dt, 1e-9), 1),
        "total_tokens": total_tokens,
        "tokens_per_request": tokens_per_request,
        "latency_ms": srv.latency_summary(),
        "faults": metrics.faults(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
