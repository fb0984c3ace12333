"""Chunked convergence driver: reference EM semantics at device speed.

The reference's convergence rule (|old - new| / |old| <= threshold, old
initialized to 1.0, the final pass NOT applying an update — T1:306-346)
forces a host decision per EM iteration.  A naive driver therefore pays a
full host<->device round trip and a program launch per iteration, which
can rival the iteration's own device time at small batch sizes.

This driver recovers device speed WITHOUT changing the trajectory:

* iterations run in device-side chunks of k as one jitted lax.scan
  (`run_chunk(state, k) -> (state_after_k_updates, lps (k,), nvs (k,))`,
  where lps[j] is the log prob computed on the state BEFORE update j);
* the host walks each chunk's fetched log probs and applies the exact
  reference rule; if convergence triggers after j updates mid-chunk, the
  kept model is recomputed as `run_chunk(chunk_start, j)` — EM is
  deterministic, so the re-run reproduces the discarded intermediate
  exactly (one extra dispatch, only on the final chunk);
* chunks are dispatched SPECULATIVELY (pipeline depth 2): while the host
  blocks fetching chunk n's log probs, chunk n+1 is already running on
  device.  If convergence triggers, the speculative work is discarded.

Net effect: per-iteration overhead drops from one round trip to
~RTT / chunk (amortized) overlapped with compute.  Used by train_fast
(isolated EM), train_embedded, and train_tied.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np


def chunked_convergence_train(
    state,
    run_chunk: Callable,
    threshold: float = 1e-3,
    max_iterations: int = 100,
    chunk: int = 8,
    pipeline: int = 2,
    log_prob_offset: float = 0.0,
    checkpoint=None,
):
    """Run `run_chunk` under the reference convergence rule.

    log_prob_offset is added to every fetched log prob before the
    convergence test and before recording history — used by CMVN-normalized
    training to apply the constant Jacobian correction INSIDE the rule (the
    reference's relative-change test is not shift-invariant).

    checkpoint: optional train.checkpoint.CheckpointManager — the model
    pytree plus the driver bookkeeping (iteration, old log prob, history)
    is saved after every fetched chunk, and a newest complete checkpoint
    in the directory resumes training mid-run with the IDENTICAL
    trajectory (EM is deterministic and the model is the complete driver
    state).  This is how ALL chunked trainers (isolated fast path,
    embedded, tied) get failure recovery — the reference loses everything
    on a crash (exit(1), T1:406-408).  Chunk granularity: a crash replays
    at most `chunk` iterations of device work.

    Returns (final_state, iterations, log_prob_history, last_num_valid).
    `run_chunk(state, k)` must run k EM iterations on device and return
    (new_state, lps, nvs) with lps[j] the total log prob evaluated on the
    model before the j-th update (the em_train_scan contract); k is
    jit-static, so at most three distinct k values compile (the chunk
    size, a tail, and a convergence prefix).
    """
    chunk = max(1, min(chunk, max_iterations))
    old = 1.0
    history: list[float] = []
    n_valid = 0
    iteration = 0
    if checkpoint is not None:
        resumed = checkpoint.latest(state)
        if resumed is not None:
            state, ck = resumed
            iteration = ck.iteration
            old = ck.old_log_prob
            history = list(ck.history)
    cur = state
    inflight: deque = deque()
    planned = iteration
    final_state = state
    converged = iteration >= max_iterations

    while True:
        while (
            not converged
            and planned < max_iterations
            and len(inflight) < pipeline
        ):
            k = min(chunk, max_iterations - planned)
            out = run_chunk(cur, k)
            inflight.append((cur, out, k))
            cur = out[0]
            planned += k
        if not inflight:
            break
        start, (after, lps, nvs), k = inflight.popleft()
        lps_h = np.asarray(lps)  # blocks on this chunk only; later chunks
        nvs_h = np.asarray(nvs)  # keep running on device meanwhile
        for j in range(k):
            iteration += 1
            lp = float(lps_h[j]) + log_prob_offset
            history.append(lp)
            n_valid = int(nvs_h[j])
            if old != 0.0 and abs((old - lp) / old) <= threshold:
                # keep the model after j updates (the reference does not
                # apply the final update); re-run the deterministic prefix
                final_state = run_chunk(start, j)[0] if j > 0 else start
                converged = True
                break
            old = lp
        if converged:
            inflight.clear()  # discard speculative chunks
            break
        final_state = after
        if checkpoint is not None:
            from .checkpoint import EmDriverState

            checkpoint.save(
                after,
                EmDriverState(
                    iteration=iteration, old_log_prob=old, history=history
                ),
            )
    if checkpoint is not None and converged:
        from .checkpoint import EmDriverState

        checkpoint.save(
            final_state,
            EmDriverState(iteration=iteration, old_log_prob=old, history=history),
        )
    return final_state, iteration, history, n_valid
