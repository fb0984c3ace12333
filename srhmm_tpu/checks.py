"""The production paths compared with the repo's plain references.

Each function runs one production path and its reference on the same
input and returns the compared numbers beside their limits, plus "ok".
chip_smoke.py runs them on the GPU at real widths; the tests run them on
the CPU at small widths (the Triton kernels in the Pallas interpreter) and,
marked `gpu`, on the card.

Tolerances (float32 throughout, every GEMM at ops/backend.PRECISION):
  * log Z of the lattice kernels vs the XLA scans: relative 1e-5 — both
    run the same logsumexp recursion in f32; they differ only in the order
    of the per-destination sums;
  * E-step statistics: max-normalized relative 1e-4 (stat_rel_err) — the
    statistics sum O(B T) posteriors in a different order;
  * isolated-word scores: relative 1e-5, and identical rankings;
  * batched decode vs per-utterance decode: identical word strings,
    scores relative 1e-4 (the batched emission GEMM may associate its
    sums differently over T ~ 1000 frames);
  * the same E-step on two backends (GPU vs host CPU): max-normalized
    relative 4 * eps_f32 * |log Z| per utterance, and at least 1e-4.  Each
    posterior is exp(log alpha + log beta - log Z) of terms |log Z| nats
    large, which f32 holds to eps * |log Z| absolute — that much relative
    error in every posterior, rounded differently on each backend (at
    config-5 width, |log Z| ~ 3.5e4 nats: a limit of ~1.7e-2).
"""

from __future__ import annotations

import jax
import numpy as np

LOG_Z_RTOL = 1e-5
STAT_RTOL = 1e-4
SCORE_RTOL = 1e-5
DECODE_RTOL = 1e-4


def stat_rel_err(ref, got) -> float:
    """Largest max-normalized relative difference over every statistic of
    two SuffStats (each array's error over max(|ref|, 1))."""
    worst = 0.0
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0)))
    return worst


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def compare_e_step(model, batch, interpret: bool = False) -> dict:
    """The E-step on the Triton lattice kernels vs the XLA-scan E-step."""
    from .train.em import e_step

    ref = e_step(model, batch, lattice="xla")
    got = e_step(model, batch, lattice="triton", interpret=interpret)
    out = {
        "log_z_rel": _rel(float(got.log_prob), float(ref.log_prob)),
        "log_z_limit": LOG_Z_RTOL,
        "stat_rel": stat_rel_err(ref, got),
        "stat_limit": STAT_RTOL,
        "num_valid": float(got.num_valid),
    }
    out["ok"] = bool(
        out["log_z_rel"] <= LOG_Z_RTOL
        and out["stat_rel"] <= STAT_RTOL
        and float(got.num_valid) == float(ref.num_valid)
    )
    return out


def compare_scores(vocab, batch, mode: str = "total", final_states=None,
                   interpret: bool = False) -> dict:
    """score_batch_lattice (Triton forward) vs score_batch_log (XLA scan):
    relative error over finite scores, identical per-utterance rankings."""
    from .decode.scorer import rank, score_batch_lattice, score_batch_log

    ref = np.asarray(
        score_batch_log(vocab, batch, mode=mode, final_states=final_states)
    )
    got = np.asarray(
        score_batch_lattice(
            vocab, batch, mode=mode, final_states=final_states,
            interpret=interpret,
        )
    )
    fin = np.isfinite(ref)
    rel = (
        float(np.max(np.abs(got[fin] - ref[fin]) / np.maximum(np.abs(ref[fin]), 1.0)))
        if fin.any() else 0.0
    )
    same_inf = bool((np.isfinite(got) == fin).all())
    ranks_same = all(
        (rank(ref[b]) == rank(got[b])).all() for b in range(ref.shape[0])
    )
    return {
        "score_rel": rel,
        "score_limit": SCORE_RTOL,
        "ranks_identical": ranks_same,
        "ok": bool(rel <= SCORE_RTOL and same_inf and ranks_same),
    }


def compare_batched_decode(vocab, batch, utterances, n_best: int = 1,
                           **decode_kwargs) -> dict:
    """decode_continuous_batch on the whole batch vs decode_continuous on
    each of `utterances` (batch row indices) alone."""
    from .decode.continuous import decode_continuous, decode_continuous_batch

    got = decode_continuous_batch(vocab, batch, n_best=n_best, **decode_kwargs)
    batches = batch if isinstance(batch, (tuple, list)) else (batch,)
    lengths = np.asarray(batches[0].lengths)
    same_words = True
    worst = 0.0
    for b in utterances:
        L = int(lengths[b])
        frames = tuple(bb.features[b, :L] for bb in batches)
        ref = decode_continuous(
            vocab, frames if len(frames) > 1 else frames[0], n_best=n_best,
            final_states=decode_kwargs.get("final_states"),
            **{k: v for k, v in decode_kwargs.items() if k != "final_states"},
        )[:n_best]
        hyps = [got[b]] if n_best == 1 else got[b]
        same_words &= [h[1] for h in hyps] == [h[1] for h in ref]
        same_words &= [h[2] for h in hyps] == [h[2] for h in ref]
        for h, r in zip(hyps, ref):
            worst = max(worst, _rel(h[0], r[0]))
    return {
        "words_identical": bool(same_words),
        "score_rel": worst,
        "score_limit": DECODE_RTOL,
        "utterances": len(utterances),
        "ok": bool(same_words and worst <= DECODE_RTOL),
    }


def compare_on_cpu(fn, *args, log_z_scale: float = 0.0) -> dict:
    """fn(*args) on the default device vs on the host CPU backend in the
    same process; fn returns a pytree of arrays whose leaves are compared
    max-normalized (stat_rel_err's form).  log_z_scale: the per-utterance
    |log Z| of the data, which sets the limit (see the module docstring)."""
    got = jax.block_until_ready(fn(*args))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = fn(*jax.device_put(args, cpu))
    err = stat_rel_err(ref, got)
    limit = max(STAT_RTOL, 4 * float(np.finfo(np.float32).eps) * log_z_scale)
    return {"stat_rel": err, "stat_limit": limit, "ok": bool(err <= limit)}
