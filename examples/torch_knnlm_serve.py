"""kNN-LM retrieval serving through the continuous-batching scheduler, on
the PyTorch port (the twin of examples/knnlm_serve.py, through
``repro_torch``; it runs on CUDA unless ``--device cpu`` is given).

Decode-time hidden states join (as R) against a MUTABLE datastore of
hidden-state keys (as S, sparse-ified by top-magnitude truncation — the
standard trick for billion-entry datastores); the retrieved values'
next tokens re-weight the LM distribution:

    p(y) = (1 - lam) * p_LM(y) + lam * softmax_knn(y)

This is the showcase for the serving stack (DESIGN.md §7 + §8):

* the datastore lives in a :class:`ShardedKNNStore` — indexes built once
  per shard (1 shard here);
* queries go through :class:`repro_torch.serve.KNNScheduler`: the decode
  step's retrieval submits alongside a stream of concurrent "other user"
  requests, and the scheduler coalesces them into full r_block batches —
  ONE store dispatch serves the decode token and the background traffic;
* the store stays MUTABLE while serving: every generated token's
  (hidden-state key → next token) pair is ``add()``-ed back with a TTL,
  expired entries are tombstoned per step, and ``delete()`` evicts ids —
  all through ``scheduler.mutate()``, serialized with batch dispatches,
  with zero index rebuilds at query time;
* with ``--ckpt DIR`` the store checkpoints incrementally while serving
  (``save_dirty`` through ``mutate()`` — only mutated shards rewrite, the
  id→token value map rides in the manifest), and ``--resume`` is the
  kill-9 story: warm-restart the datastore from the newest valid commit
  (``ShardedKNNStore.load``) and keep answering with the SAME global ids
  — no index rebuild, no id reshuffle (DESIGN.md §9).

  PYTHONPATH=src python examples/torch_knnlm_serve.py [--device cpu]
  PYTHONPATH=src python examples/torch_knnlm_serve.py --ckpt /tmp/knnlm.ckpt
  # kill -9 it mid-run, then:
  PYTHONPATH=src python examples/torch_knnlm_serve.py --ckpt /tmp/knnlm.ckpt --resume
"""
import argparse
import asyncio
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import JoinSpec
from repro_torch.launch.serve import Request, Server
from repro_torch.models import model as M
from repro_torch.obs import FlightRecorder, ProfileCapture
from repro_torch.serve import KNNScheduler, ServeConfig
from repro_torch.sparse.format import SparseBatch
from repro_torch.store import ShardedKNNStore


def sparsify(h: np.ndarray, keep: int = 32) -> SparseBatch:
    """Keep the top-|keep| magnitude dims of each row (sparse keys)."""
    n, d = h.shape
    idx = np.argsort(-np.abs(h), axis=1)[:, :keep]
    idx.sort(axis=1)
    vals = np.take_along_axis(h, idx, axis=1)
    rows = np.repeat(np.arange(n), keep)
    return SparseBatch.from_coo(
        rows, idx.ravel(), vals.ravel().astype(np.float32), n, d
    )


async def main_async(ckpt: str = None, resume: bool = False,
                     flight_dump: str = None, profile_dir: str = None, device: str = "cuda"):
    t_start = time.perf_counter()
    cfg = get_config("qwen3-0.6b").reduced()
    srv = Server(cfg, batch=1, max_seq=64, seed=0, device=device)
    rng = np.random.default_rng(0)

    # ---- build a toy datastore: (hidden-state key, next token value) ----
    n_store = 256
    store_tokens = rng.integers(0, cfg.vocab_size, (n_store, 9)).astype(np.int32)
    batch = {"tokens": store_tokens[:, :-1]}
    hidden, _ = M.hidden_states(srv.params, cfg, batch)
    keys = hidden[:, -1].float().cpu().numpy()                 # (N, d)
    values = store_tokens[:, -1]                                # next tokens
    datastore = sparsify(keys)

    lam, k = 0.3, 8
    if resume:
        # kill-9 → warm restart: host mirrors + id stacks + tombstone state
        # come off disk, device stacks rebuild, global ids are STABLE — the
        # persisted id→token value map lines up with the restored id space
        t_load = time.perf_counter()
        store = ShardedKNNStore.load(ckpt, device=device)
        values = [int(v) for v in store.loaded_extra["knnlm_values"]]
        assert len(values) == store._next_gid, "value map / id space mismatch"
        print(f"resumed:   {store.num_vectors} live rows over "
              f"{store.n_shards} shard(s) in "
              f"{time.perf_counter() - t_load:.2f}s (ids stable)")
    else:
        # build the sharded datastore ONCE (every local device holds one
        # shard of S); all traffic below flows through the scheduler
        store = ShardedKNNStore.build(
            datastore, JoinSpec(k=k, algorithm="iib", r_block=8), device=device)
        values = [int(v) for v in values]   # grows with the datastore
        if ckpt:
            store.save(ckpt, extra={"knnlm_values": values})
    ttl_steps = 6                   # generated entries live this many steps

    # simulated concurrent users: perturbed datastore keys as 1-row queries
    def other_user_query() -> SparseBatch:
        base = keys[rng.integers(0, n_store)]
        return sparsify((base + 0.1 * rng.standard_normal(base.shape))[None, :])

    # ---- serve one request with kNN interpolation -----------------------
    prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    req = Request(0, prompt, max_new=8)
    assert srv.admit(req)
    step = 0
    generated = [req.out[-1]]

    # observability: a private flight recorder holds the serve→store span
    # timeline (dumped as JSONL with --flight-dump); --profile arms a
    # torch.profiler capture around the first 3 coalesced batches
    recorder = FlightRecorder(auto_dump_path=flight_dump)
    profile = ProfileCapture(profile_dir) if profile_dir else None
    sched = KNNScheduler(store, ServeConfig(r_block=8, window_s=0.005),
                         recorder=recorder, profile=profile)
    async with sched:
        while srv.occupancy():
            s = 0  # single slot
            logits, cache = srv.decode(
                srv.params, srv.slot_tok[s:s + 1],
                srv.slot_cache[s], int(srv.slot_pos[s]),
            )
            srv.slot_cache[s] = cache

            # query = current hidden state ~ final logits pre-softmax proxy:
            # recompute hidden for the query token (teacher-forced 1-step)
            qh, _ = M.hidden_states(srv.params, cfg, {"tokens": srv.slot_tok[s:s + 1]})
            query = sparsify(qh[:, -1].float().cpu().numpy())

            # the decode-step retrieval rides one coalesced batch with the
            # background users' requests — one store dispatch for all of them
            (ids, scores), *_ = await asyncio.gather(
                sched.submit(query, k=k),
                *[sched.submit(other_user_query(), k=4) for _ in range(5)],
            )
            ids, scores = ids[0], scores[0]
            valid = scores > -np.inf

            p_lm = torch.softmax(logits[0, -1], dim=-1).cpu().numpy()
            p_knn = np.zeros_like(p_lm)
            if valid.any():
                w = np.exp(scores[valid] - scores[valid].max())
                w /= w.sum()
                for wi, sid in zip(w, ids[valid]):
                    p_knn[values[sid]] += wi
                p = (1 - lam) * p_lm + lam * p_knn
            else:
                p = p_lm
            nxt = int(p.argmax())
            generated.append(nxt)
            srv.slot_tok[s, 0] = nxt
            srv.slot_pos[s] += 1
            req.out.append(nxt)

            # ---- mutate the datastore while serving --------------------
            # feed the fresh (key -> generated token) pair back with a TTL
            # and tombstone whatever expired this step — serialized with
            # the query batches, no index rebuild either way
            new_gids = await sched.mutate(
                store.add, query, ttl=ttl_steps, now=float(step))
            values.append(nxt)
            assert len(values) == int(new_gids[-1]) + 1
            await sched.mutate(store.expire, float(step))
            if ckpt:
                # incremental commit, serialized with dispatches: only the
                # shards this step's add/expire touched are rewritten
                await sched.mutate(
                    store.save_dirty, ckpt, {"knnlm_values": values})
            step += 1

            if len(req.out) >= req.max_new:
                srv.slot_req[s] = None

        # explicit eviction: drop the two lowest-id seed entries
        await sched.mutate(store.delete, [0, 1])
        if ckpt:
            await sched.mutate(
                store.save_dirty, ckpt, {"knnlm_values": values})
        builds_before = store.stats.index_builds
        await sched.submit(query, k=k)
        assert store.stats.index_builds == builds_before, "query rebuilt an index!"

    m = sched.metrics
    assert m.query_index_builds == 0, "serving performed a query-time build!"
    assert m.completed == m.submitted
    assert m.batches < m.completed, "no coalescing happened"

    print("prompt:   ", prompt.tolist())
    print("generated:", generated)
    print("datastore hits blended with lam =", lam)
    print(f"datastore: {store.stats.index_builds} block-index builds for "
          f"{m.completed} scheduled queries over {store.n_shards} shard(s); "
          f"{store.stats.expired} entries TTL-expired, "
          f"{store.stats.deleted} deleted, live rows {store.num_vectors}")
    lat = m.summary()["latency"]
    occ = m.summary()["batches"]["mean_occupancy"]
    print(f"serving:   {m.completed} requests in {m.batches} coalesced "
          f"batches (occupancy {occ}), p50 {lat['p50_ms']}ms "
          f"p99 {lat['p99_ms']}ms")
    ph = m.phase_summary()
    print("phases:    " + "  ".join(
        f"{name} p50 {ph[name]['p50_ms']}ms"
        for name in ("queue_wait", "pad", "dispatch", "post")))
    rs = recorder.summary()
    print(f"recorder:  {rs['events']} events ({rs['faults']} faults) — "
          f"{rs['by_kind']}")
    if flight_dump:
        print(f"flight recorder dumped to {recorder.dump(flight_dump)}")
    if profile is not None:
        print(f"profiler:  {profile.summary()}")
    print("summary:", json.dumps({
        "device": str(srv.device), "decode_steps": step, "generated": len(generated),
        "scheduled_queries": m.completed, "batches": m.batches,
        "store_rows": store.num_vectors, "index_builds": store.stats.index_builds,
        "query_index_builds": m.query_index_builds,
        "wall_s": round(time.perf_counter() - t_start, 3)}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir: save on build + incrementally "
                         "while serving")
    ap.add_argument("--resume", action="store_true",
                    help="warm-restart the datastore from --ckpt instead "
                         "of building it")
    ap.add_argument("--flight-dump", default=None,
                    help="dump the serving flight recorder (spans + fault "
                         "events) to this JSONL path at exit")
    ap.add_argument("--profile", default=None,
                    help="capture a torch.profiler trace of the first 3 "
                         "batches into this logdir")
    ap.add_argument("--device", default="cuda", help="compute device (cuda unless cpu)")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt:
        ap.error("--resume requires --ckpt")
    asyncio.run(main_async(ckpt=args.ckpt, resume=args.resume,
                           flight_dump=args.flight_dump,
                           profile_dir=args.profile, device=args.device))


if __name__ == "__main__":
    main()
