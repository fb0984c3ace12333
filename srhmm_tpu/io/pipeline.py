"""Async input pipeline: prefetch + double-buffer to device.

The reference blocks on stdio reads INSIDE its EM loop — every .perfil is
re-read from disk twice per utterance per iteration
(train/source/hmm-full-fs/hmm_continuous_full_fs.c:258-269, re-reads at
:259/:287).  The replacement here (SURVEY §2.4 threads/async-I/O row) is a
classic double buffer: a background thread produces the NEXT shard —
running the batched loader (io/dataset.load_batch -> the native C++
worker-pool loader) and/or the host->device transfer — while the main
thread computes on the CURRENT shard.  With depth=2 the steady-state cost
per shard is max(load+transfer, compute) instead of their sum.

Used by train/streaming.py (EM over device-memory-exceeding datasets:
every iteration streams all shards, statistics accumulate on device) and
the fast train CLI's --stream-shards mode.
"""

from __future__ import annotations

from queue import Queue
from threading import Thread
from typing import Callable, Iterable, Sequence

import jax


class PrefetchLoader:
    """Iterate over shards with background production.

    sources: a sequence of shard descriptors (anything `load_fn` accepts —
    path lists, host arrays, UtteranceBatch of numpy arrays, ...).
    load_fn: called on the background thread; returns the ready-to-compute
    value (typically an UtteranceBatch of DEVICE arrays — do the
    `jax.device_put` inside so the H2D copy overlaps compute too).
    depth: queue capacity; 2 = double buffer (one in compute, one in
    flight).

    Exceptions on the producer thread propagate to the consumer at the
    point of iteration.  The iterator is single-pass; construct a fresh
    PrefetchLoader per epoch/EM iteration.
    """

    def __init__(
        self,
        sources: Sequence,
        load_fn: Callable,
        depth: int = 2,
    ) -> None:
        if depth < 1:
            raise ValueError("PrefetchLoader: depth must be >= 1")
        self.sources = list(sources)
        self.load_fn = load_fn
        self.depth = depth

    def __len__(self) -> int:
        return len(self.sources)

    def __iter__(self):
        q: Queue = Queue(maxsize=self.depth)
        sentinel = object()
        errors: list[BaseException] = []

        def worker():
            try:
                for src in self.sources:
                    q.put(self.load_fn(src))
            except BaseException as e:  # propagate to the consumer
                errors.append(e)
            finally:
                q.put(sentinel)

        t = Thread(target=worker, name="prefetch-loader", daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                t.join()
                if errors:
                    raise errors[0]
                return
            yield item


def device_put_loader(
    host_batches: Sequence, depth: int = 2, device=None
) -> PrefetchLoader:
    """PrefetchLoader over pre-loaded HOST shards: the background thread
    only does the H2D transfer (`jax.device_put`) — the device-memory-bound
    streaming case (dataset fits host RAM, not HBM)."""

    def put(b):
        return jax.tree.map(
            lambda a: jax.device_put(a, device), b
        )

    return PrefetchLoader(host_batches, put, depth=depth)
