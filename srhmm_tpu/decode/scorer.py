"""Isolated-word scoring.

The reference walks a linked list of word models and, for every word,
re-reads the utterance from disk and re-runs emission + forward
(recognition-fs/recognition_continuous_fs.c:341-369 — 13x redundant I/O per
utterance).  Here the whole vocabulary is a stacked pytree and one jitted,
vmapped computation scores every word at once; a batch axis over utterances
vmaps on top of that.

Two scoring modes, matching the two reference recognizer variants:
  * "total"  — total probability, R1 (recognition-full-fs:822-836)
  * "final"  — final-state probability, R2 (recognition-fs:820-836)
and two numerics modes: log-space fast path and float64 probability-domain
parity path (exact reference semantics including clamps).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.gmm_hmm import GmmHmm
from ..ops import backend
from ..ops.emission import log_state_emission, prob_emission_parity
from ..ops.forward_backward import (
    log_forward,
    parity_score_final_state,
    parity_score_total,
    scaled_forward_parity,
    score_final_state,
    score_total,
)

TOTAL = "total"
FINAL = "final"


def _score_vocab_log(
    vocab: GmmHmm,
    frames_per_stream: tuple[jax.Array, ...],
    mode: str = TOTAL,
    length: jax.Array | None = None,
    final_states: jax.Array | None = None,
) -> jax.Array:
    def one_word(word_model: GmmHmm, fs) -> jax.Array:
        log_b = None
        for frames, stream in zip(frames_per_stream, word_model.streams):
            lb = log_state_emission(frames, (stream,))
            log_b = lb if log_b is None else log_b + lb
        la = log_forward(log_b, word_model.log_trans(), length)
        if mode == TOTAL:
            # padded filler states (pad_stack_models) are unreachable: their
            # log-alpha is -inf and drops out of the logsumexp
            return score_total(la)
        return la[fs] if fs is not None else score_final_state(la)

    if final_states is None:
        return jax.vmap(lambda m: one_word(m, None))(vocab)
    return jax.vmap(one_word)(vocab, final_states)


@partial(jax.jit, static_argnames=("mode",))
def score_vocab_log(
    vocab: GmmHmm,
    frames_per_stream: tuple[jax.Array, ...],
    mode: str = TOTAL,
    length: jax.Array | None = None,
    final_states: jax.Array | None = None,
) -> jax.Array:
    """Log-space scores of one utterance against a stacked vocabulary.

    vocab: GmmHmm with leading word axis W; frames_per_stream: one (T, D_p)
    array per stream.  final_states: optional (W,) per-word final-state
    indices (heterogeneous vocabularies padded by pad_stack_models).
    Returns (W,) scores (higher = better).
    """
    return _score_vocab_log(vocab, frames_per_stream, mode, length, final_states)


@partial(jax.jit, static_argnames=("mode",))
def score_batch_log(
    vocab: GmmHmm,
    batch,
    mode: str = TOTAL,
    final_states: jax.Array | None = None,
) -> jax.Array:
    """Score a padded utterance batch against a stacked vocabulary.

    vocab: GmmHmm with leading word axis W; batch: UtteranceBatch (B, T, D),
    or a tuple of per-stream UtteranceBatch objects for MULTI-STREAM
    vocabularies (the reference reads one .perfil per stream, R2:331-339).
    Returns (B, W) scores — every utterance against every word in one
    batched computation (the reference's quadruple loop R2:283-369 with its
    13x redundant .perfil re-reads collapses into this).
    """
    batches = batch if isinstance(batch, tuple) else (batch,)
    return jax.vmap(
        lambda fs, l: _score_vocab_log(vocab, fs, mode, l, final_states)
    )(tuple(b.features for b in batches), batches[0].lengths)


@partial(jax.jit, static_argnames=("mode", "interpret"))
def score_batch_lattice(
    vocab: GmmHmm,
    batch,
    mode: str = TOTAL,
    final_states: jax.Array | None = None,
    interpret: bool = False,
) -> jax.Array:
    """score_batch_log with the forward recursion on the Triton lattice
    kernel (ops/lattice_triton.py): emissions for every (utterance, word)
    pair as one XLA computation, then ONE kernel launch runs the forward
    recursion over all B*W lanes, each lane with its word's transitions.
    Same (B, W) result as score_batch_log."""
    from ..ops.lattice_triton import forward_lattice

    batches = batch if isinstance(batch, tuple) else (batch,)
    lengths = batches[0].lengths

    def word_log_b(fs, word_model):  # (T, S) for one utterance and word
        log_b = None
        for frames, stream in zip(fs, word_model.streams):
            lb = log_state_emission(frames, (stream,))
            log_b = lb if log_b is None else log_b + lb
        return log_b

    log_b = jax.vmap(
        lambda fs: jax.vmap(lambda m: word_log_b(fs, m))(vocab)
    )(tuple(b.features for b in batches))  # (B, W, T, S)
    B, W, T, S = log_b.shape
    lanes = jnp.transpose(log_b, (2, 3, 0, 1)).reshape(T, S, B * W)
    log_trans = jnp.broadcast_to(
        vocab.log_trans().astype(log_b.dtype)[None], (B, W, S, S)
    )
    log_trans = jnp.transpose(log_trans, (2, 3, 0, 1)).reshape(S, S, B * W)
    la = forward_lattice(
        lanes, log_trans, jnp.repeat(lengths, W), final_only=True,
        interpret=interpret,
    ).reshape(S, B, W)
    if mode == TOTAL:
        return jax.nn.logsumexp(la, axis=0)
    if final_states is None:
        return la[S - 1]
    return jnp.take_along_axis(la, final_states[None, None, :], axis=0)[0]


def score_batch(
    vocab: GmmHmm,
    batch,
    mode: str = TOTAL,
    final_states: jax.Array | None = None,
) -> jax.Array:
    """Batch scoring: every utterance against every word, (B, W) scores.
    The forward recursion runs on the implementation ops/backend.py picks
    for the platform: the Triton lattice kernel (score_batch_lattice) on a
    GPU for single-device inputs, the vmapped XLA scan (score_batch_log)
    otherwise.  `batch` may be a per-stream tuple for multi-stream
    vocabularies (the reference's product-of-streams scoring,
    R2:352-358)."""
    batches = batch if isinstance(batch, tuple) else (batch,)
    if backend.lattice_impl(*(b.features for b in batches)) == backend.TRITON:
        return score_batch_lattice(
            vocab, batch, mode=mode, final_states=final_states
        )
    return score_batch_log(vocab, batch, mode=mode, final_states=final_states)


@partial(jax.jit, static_argnames=("mode",))
def score_vocab_parity(
    vocab: GmmHmm,
    frames_per_stream: tuple[jax.Array, ...],
    mode: str = TOTAL,
    final_states: jax.Array | None = None,
) -> jax.Array:
    """Float64 probability-domain scores replicating the reference exactly.

    final_states: optional (W,) per-word final-state indices for padded
    heterogeneous vocabularies (pad_stack_models)."""

    def one_word(word_model: GmmHmm, fs) -> jax.Array:
        b = prob_emission_parity(list(frames_per_stream), word_model.streams)
        alpha, scaling = scaled_forward_parity(b, word_model.trans)
        if mode == TOTAL:
            return parity_score_total(scaling)
        if fs is None:
            return parity_score_final_state(scaling, alpha)
        return -jnp.sum(jnp.log(scaling)) + jnp.log(alpha[-1, fs])

    if final_states is None:
        return jax.vmap(lambda m: one_word(m, None))(vocab)
    return jax.vmap(one_word)(vocab, final_states)


def rank(scores: np.ndarray) -> np.ndarray:
    """Descending-score ranking with stable ties; NaN scores rank last.

    This is the *sane* ranking for the fast path.  It intentionally differs
    from the reference for NaN inputs — see rank_c_parity.
    """
    scores = np.asarray(scores)
    # place NaNs below every finite/-inf score
    keys = np.where(np.isnan(scores), -np.inf, scores)
    nan_penalty = np.isnan(scores).astype(np.int64)  # tie-break NaNs last
    order = np.lexsort((np.arange(len(scores)), nan_penalty, -keys))
    return order


def rank_c_parity(scores: np.ndarray) -> np.ndarray:
    """The reference's `sorting_probab` bubble sort, literally (R2:968-995).

    Load-bearing quirk: `if (probab[index[i]] < probab[index[i+1]]) swap` is
    false for any comparison involving NaN, so NaN entries freeze the
    permutation around them.  With the committed full-cov models most
    cross-word scores underflow to NaN, the sort returns the *identity*
    permutation, and word 0 (vc_186...) "wins" every utterance — which is
    exactly how the golden report test/test/result/hmm-result.txt gets its
    1/13 = 7.69% accuracy.  Reproducing that report requires this sort.
    """
    scores = np.asarray(scores)
    idx = list(range(len(scores)))
    done = False
    while not done:
        done = True
        for i in range(len(scores) - 1):
            if scores[idx[i]] < scores[idx[i + 1]]:
                idx[i], idx[i + 1] = idx[i + 1], idx[i]
                done = False
    return np.asarray(idx)
