"""Sharded mutable KNN datastore on one device.

  ShardedKNNStore — S partitioned row-wise into shards, one index stack set
                    per shard (built once, reused across queries), every
                    shard on one device and each replica in tensors of its
                    own; ``query(R)`` walks each R block against every shard
                    and tree-reduces the per-shard top-k states through the
                    topk_merge kernel.
  StoreStats      — store-lifetime work accounting (dispatches, syncs,
                    index builds, placements, tombstone/compaction and
                    replica counters).
"""
from repro_torch.store.sharded import ShardedKNNStore, StoreStats

__all__ = ["ShardedKNNStore", "StoreStats"]
