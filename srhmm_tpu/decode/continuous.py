"""Continuous recognition: composed-HMM token passing, N-best decode.

The reference only recognizes isolated words (one forward score per whole
utterance per word, R2:341-369).  Continuous strings (BASELINE.json config 3)
need word models composed into a decoding graph and a frame-synchronous
Viterbi over the composed state space.

Design:

* the composed graph is a dense (S_tot, S_tot) log-transition matrix (the
  reference engine) or its block factorization (BlockGraph: per-word
  (S, S) blocks plus a (W, W) exit->entry arc matrix, the production
  engine); emissions come from the stacked vocabulary in one batched GEMM
  (T, W, S) -> (T, S_tot);
* decoding is one `lax.scan` carrying (S_tot, K) K-best token scores — the
  N-best semiring: each step does a dense candidate expansion
  (S_from x K) + trans -> top-K per destination state, with backpointers
  stored as flat (from_state * K + k) indices for the backtrace scan;
* word boundaries are recovered from the backtrace by detecting exit->entry
  arc crossings (state_to_word changes or re-entry into an entry state);
* `decode_continuous_batch` vmaps the block engine over a padded batch
  with length masks, so a batch decodes as one program.

`compose_sequence` builds the left-to-right concatenation of per-unit models
for a known transcript — the graph used by forced alignment and embedded
re-estimation (train/embedded.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from ..models.gmm_hmm import GmmHmm
from ..ops.emission import log_state_emission


@pytree.dataclass
class ComposedGraph:
    """A decoding graph over the composed state space of a stacked vocab.

    log_trans: (S_tot, S_tot); state_to_word: (S_tot,) int32;
    entry/exit: (W,) int32 composed-state ids; log_entry: (S_tot,) initial
    scores (word entries get lm + entry prob; others -inf).
    """

    log_trans: jax.Array
    state_to_word: jax.Array
    entry_states: jax.Array
    exit_states: jax.Array
    log_entry: jax.Array
    words: tuple = pytree.static_field(default=())


def compose_word_loop(
    vocab: GmmHmm,
    lm_logprobs: np.ndarray | None = None,
    exit_logprob: float = np.log(0.1),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial: np.ndarray | None = None,
) -> ComposedGraph:
    """Word-loop graph: every word's left-right HMM, with an arc from each
    word's final state to every word's entry state, enabling unrestricted
    word sequences.

    lm_logprobs: language-model scores over the vocabulary —
      * None: uniform unigram (-log W);
      * shape (W,): unigram log-probs, same score into word v from any
        predecessor;
      * shape (W, W): bigram log P(next=v | prev=w) — row w weights the arcs
        out of word w's exit state.  The word-loop state space identifies the
        previous word at every exit state, so a bigram needs no state-space
        expansion (higher-order LMs would; documented non-goal here).
    lm_scale: multiplier on all LM scores (the standard acoustic/LM balance
      knob; the reference has no LM at all — its model-set weights
      `coef_model`, R2:193-196, scale *acoustic* scores and live in
      cli/recognize.py).
    word_insertion_penalty: additive log-score per word transition (negative
      discourages insertions); applied on exit->entry arcs only, so an
      N-word hypothesis accumulates (N-1) penalties.
    lm_initial: optional (W,) log-probs for the first word; defaults to
      lm_logprobs when that is a unigram, uniform when it is a bigram.
    """
    W = vocab.trans.shape[0]
    S = vocab.trans.shape[-1]
    S_tot = W * S
    if lm_logprobs is None:
        lm_logprobs = np.full(W, -np.log(W))
    lm_logprobs = np.asarray(lm_logprobs, dtype=np.float64)
    if lm_logprobs.ndim == 1:
        arc_lm = np.broadcast_to(lm_logprobs, (W, W))
        initial = lm_logprobs if lm_initial is None else np.asarray(lm_initial)
    elif lm_logprobs.shape == (W, W):
        arc_lm = lm_logprobs
        initial = (
            np.full(W, -np.log(W)) if lm_initial is None else np.asarray(lm_initial)
        )
    else:
        raise ValueError(
            f"lm_logprobs must be (W,) or (W, W) for W={W}, got {lm_logprobs.shape}"
        )

    lt = np.full((S_tot, S_tot), -np.inf)
    trans = np.asarray(vocab.trans)
    with np.errstate(divide="ignore"):
        log_word_trans = np.where(trans > 0, np.log(np.maximum(trans, 1e-300)), -np.inf)
    for w in range(W):
        lt[w * S : (w + 1) * S, w * S : (w + 1) * S] = log_word_trans[w]
    entry = np.arange(W) * S
    exit_ = np.arange(W) * S + (S - 1)
    for w in range(W):
        lt[exit_[w], entry] = np.maximum(
            lt[exit_[w], entry],
            exit_logprob + lm_scale * arc_lm[w] + word_insertion_penalty,
        )

    log_entry = np.full(S_tot, -np.inf)
    log_entry[entry] = lm_scale * initial

    return ComposedGraph(
        log_trans=jnp.asarray(lt),
        state_to_word=jnp.asarray(np.repeat(np.arange(W, dtype=np.int32), S)),
        entry_states=jnp.asarray(entry.astype(np.int32)),
        exit_states=jnp.asarray(exit_.astype(np.int32)),
        log_entry=jnp.asarray(log_entry),
        words=tuple(vocab.word) if isinstance(vocab.word, tuple) else (),
    )


def compose_sequence(vocab: GmmHmm, transcript: list[int]) -> ComposedGraph:
    """Left-to-right concatenation of the models in `transcript` (word/phone
    ids into the stacked vocab): unit k's final state feeds unit k+1's entry.
    This is the embedded-training / forced-alignment graph."""
    S = vocab.trans.shape[-1]
    L = len(transcript)
    S_tot = L * S
    trans = np.asarray(vocab.trans)
    with np.errstate(divide="ignore"):
        logt = np.where(trans > 0, np.log(np.maximum(trans, 1e-300)), -np.inf)
    lt = np.full((S_tot, S_tot), -np.inf)
    for k, w in enumerate(transcript):
        lt[k * S : (k + 1) * S, k * S : (k + 1) * S] = logt[w]
        if k + 1 < L:
            # exit from unit k's final state into unit k+1's first state; use
            # the final state's self-loop mass as the exit weight so rows stay
            # sub-stochastic rather than inventing probability
            lt[k * S + S - 1, (k + 1) * S] = logt[w][S - 1, S - 1]
    log_entry = np.full(S_tot, -np.inf)
    log_entry[0] = 0.0
    return ComposedGraph(
        log_trans=jnp.asarray(lt),
        state_to_word=jnp.asarray(
            np.repeat(np.asarray(transcript, dtype=np.int32), S)
        ),
        entry_states=jnp.asarray((np.arange(L) * S).astype(np.int32)),
        exit_states=jnp.asarray((np.arange(L) * S + S - 1).astype(np.int32)),
        log_entry=jnp.asarray(log_entry),
        words=tuple(vocab.word) if isinstance(vocab.word, tuple) else (),
    )


def composed_emissions(vocab: GmmHmm, frames) -> jax.Array:
    """(T, S_tot) emission log-likelihoods for the composed space: one
    batched computation over the stacked vocabulary.

    frames: (T, D) shared-stream frames, or a tuple of per-stream (T, D_p)
    arrays for MULTI-STREAM vocabularies — per-stream emissions sum in log
    space (the reference's product-of-streams semantics, R2:352-358,
    lifted to the composed graph; round 5)."""
    per_word = jax.vmap(
        lambda m: log_state_emission(frames, m.streams)
    )(vocab)  # (W, T, S)
    W, T, S = per_word.shape
    return jnp.transpose(per_word, (1, 0, 2)).reshape(T, W * S)


def emissions_for_graph(
    vocab: GmmHmm, graph: ComposedGraph, frames
) -> jax.Array:
    """(T, S_tot) emissions for an arbitrary composed graph: computed per
    unique word then gathered by state_to_word (sequence graphs repeat
    units, so compute once per word, not per occurrence).  frames may be a
    per-stream tuple (see composed_emissions)."""
    per_word = jax.vmap(lambda m: log_state_emission(frames, m.streams))(vocab)
    S = per_word.shape[-1]
    n_states = graph.state_to_word.shape[0]
    within = jnp.arange(n_states) % S
    return jnp.transpose(per_word, (1, 0, 2))[:, graph.state_to_word, within]


@partial(jax.jit, static_argnames=("n_best", "beam"))
def token_passing(
    graph: ComposedGraph,
    log_b: jax.Array,
    length: jax.Array | None = None,
    n_best: int = 1,
    beam: float | None = None,
):
    """Frame-synchronous K-best Viterbi over the composed graph.

    log_b: (T, S_tot).  Returns (scores (S_tot, K) at the last valid frame,
    backpointers (T-1, S_tot, K) flat from-(state*K+k) indices).

    beam: optional log-domain beam width — tokens more than `beam` below the
    frame's best token are pruned to -inf (exact decode when None; histogram
    pruning for large composed graphs).  Vectorized: pruning is a mask, not
    a dynamic active list, so the step stays a dense computation.
    """
    T, S_tot = log_b.shape
    K = n_best
    init = graph.log_entry[:, None] + log_b[0][:, None]  # (S, 1) -> pad K
    init = jnp.concatenate(
        [init, jnp.full((S_tot, K - 1), -jnp.inf, log_b.dtype)], axis=1
    )
    id_bp = (jnp.arange(S_tot)[:, None] * K + jnp.arange(K)[None, :]).astype(
        jnp.int32
    )

    def step(carry, inputs):
        lb, t = inputs
        # candidates into state j: carry[i, k] + log_trans[i, j]
        cand = carry[:, :, None] + graph.log_trans[:, None, :]  # (S, K, S_to)
        cand = cand.reshape(S_tot * K, S_tot)
        top, idx = jax.lax.top_k(cand.T, K)  # (S_to, K)
        new = top + lb[:, None]
        if beam is not None:
            best = jnp.max(new)
            new = jnp.where(new >= best - beam, new, -jnp.inf)
        bp = idx.astype(jnp.int32)
        if length is not None:
            keep = t < length
            new = jnp.where(keep, new, carry)
            bp = jnp.where(keep, bp, id_bp)
        return new, bp

    ts = jnp.arange(1, T)
    final, bps = jax.lax.scan(step, init, (log_b[1:], ts))
    return final, bps


@pytree.dataclass
class BlockGraph:
    """Block-structured word-loop graph: the dense (S_tot, S_tot) matrix of
    ComposedGraph factors into per-word (W, S, S) within-word blocks plus a
    (W, W) exit->entry arc matrix.  Token passing then costs
    O(W S^2 K + W^2 K) per frame instead of the dense O((W S K) W S) —
    sub-quadratic in W for the left-right word HMMs where almost all dense
    entries are -inf.  Backpointers use the same flat (w*S+s)*K + k encoding
    as the dense path, so backtrace_words works on either."""

    log_trans: jax.Array  # (W, S, S) within-word log-transitions
    arc: jax.Array  # (W, W) exit->entry arc log-weights (lm, penalty incl.)
    log_entry: jax.Array  # (W,) initial scores at each word's entry state
    words: tuple = pytree.static_field(default=())
    # (W,) within-word EXIT state index per word, or None for the
    # homogeneous S-1 (round 5: HETEROGENEOUS word lengths — words padded
    # to a common stride by pad_stack_models keep their real final state)
    exit_states: jax.Array | None = None


def compose_word_loop_blocks(
    vocab: GmmHmm,
    lm_logprobs: np.ndarray | None = None,
    exit_logprob: float = np.log(0.1),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial: np.ndarray | None = None,
    final_states: np.ndarray | None = None,
) -> BlockGraph:
    """Block-structured equivalent of compose_word_loop (same LM arguments,
    same arc semantics — test-locked equal decodes).

    final_states: optional (W,) REAL final-state index per word — for
    HETEROGENEOUS vocabularies stacked by models.pad_stack_models (filler
    states are unreachable self-loops past each word's real exit); the
    engines then read exits and attach cross-word arcs at these rows
    (round 5)."""
    W = vocab.trans.shape[0]
    if lm_logprobs is None:
        lm_logprobs = np.full(W, -np.log(W))
    lm_logprobs = np.asarray(lm_logprobs, dtype=np.float64)
    if lm_logprobs.ndim == 1:
        arc_lm = np.broadcast_to(lm_logprobs, (W, W))
        initial = lm_logprobs if lm_initial is None else np.asarray(lm_initial)
    elif lm_logprobs.shape == (W, W):
        arc_lm = lm_logprobs
        initial = (
            np.full(W, -np.log(W)) if lm_initial is None else np.asarray(lm_initial)
        )
    else:
        raise ValueError(
            f"lm_logprobs must be (W,) or (W, W) for W={W}, got {lm_logprobs.shape}"
        )
    trans = np.asarray(vocab.trans)
    with np.errstate(divide="ignore"):
        log_word_trans = np.where(trans > 0, np.log(np.maximum(trans, 1e-300)), -np.inf)
    arc = exit_logprob + lm_scale * arc_lm + word_insertion_penalty
    return BlockGraph(
        log_trans=jnp.asarray(log_word_trans),
        arc=jnp.asarray(arc),
        log_entry=jnp.asarray(lm_scale * initial),
        words=tuple(vocab.word) if isinstance(vocab.word, tuple) else (),
        exit_states=(
            None
            if final_states is None
            else jnp.asarray(np.asarray(final_states), jnp.int32)
        ),
    )


@partial(jax.jit, static_argnames=("n_best", "beam"))
def token_passing_blocks(
    graph: BlockGraph,
    log_b: jax.Array,
    length: jax.Array | None = None,
    n_best: int = 1,
    beam: float | None = None,
):
    """Frame-synchronous K-best Viterbi over the block-structured word loop.

    log_b: (T, W*S) composed emissions (same layout as composed_emissions).
    Returns (scores (W*S, K) at the last valid frame, backpointers
    (T-1, W*S, K) flat (w*S+s)*K + k indices) — identical contract (and
    test-locked identical values) to the dense token_passing, at
    O(W S^2 K + W^2 K) per frame."""
    T = log_b.shape[0]
    W, S, _ = graph.log_trans.shape
    K = n_best
    lb = log_b.reshape(T, W, S)
    neg = jnp.asarray(-jnp.inf, log_b.dtype)

    init = jnp.full((W, S, K), neg, log_b.dtype)
    init = init.at[:, 0, 0].set(
        (graph.log_entry + lb[0, :, 0]).astype(log_b.dtype)
    )
    # non-entry states unreachable at t=0 (dense path: log_entry is -inf
    # off-entry); keep K>0 slots -inf
    flat_ids = (
        (jnp.arange(W * S)[:, None] * K + jnp.arange(K)[None, :])
        .astype(jnp.int32)
        .reshape(W, S, K)
    )

    lt = graph.log_trans.astype(log_b.dtype)  # (W, S, S)
    arc = graph.arc.astype(log_b.dtype)  # (W, W)

    def step(carry, inputs):
        lbt, t = inputs  # (W, S), scalar
        # within-word: candidates into (w, j) from (w, i, k)
        cand_in = carry[:, :, :, None] + lt[:, :, None, :]  # (W, i, K, j)
        cand_in = cand_in.reshape(W, S * K, S)
        top_in, idx_in = jax.lax.top_k(
            jnp.swapaxes(cand_in, 1, 2), K
        )  # (W, j, K) values + indices into (i*K + k)
        # flat encoding of the within-word source: (w*S + i)*K + k
        i_src = idx_in // K
        k_src = idx_in % K
        bp_in = ((jnp.arange(W)[:, None, None] * S + i_src) * K + k_src).astype(
            jnp.int32
        )

        # cross-word: exit tokens of every word -> every entry state
        if graph.exit_states is None:
            exit_tok = carry[:, S - 1, :]  # (W, K)
            exit_off = jnp.full((W,), S - 1, jnp.int32)
        else:  # heterogeneous word lengths: per-word real exit rows
            exit_off = graph.exit_states.astype(jnp.int32)
            exit_tok = jnp.take_along_axis(
                carry, exit_off[:, None, None], axis=1
            )[:, 0, :]
        cross = exit_tok[:, None, :] + arc[:, :, None]  # (from_w, to_v, K)
        cross = jnp.swapaxes(cross, 0, 1).reshape(W, W * K)  # (to_v, from_w*K)
        top_x, idx_x = jax.lax.top_k(cross, K)  # (W, K)
        w_src = idx_x // K
        kx_src = idx_x % K
        bp_x = ((w_src * S + exit_off[w_src]) * K + kx_src).astype(jnp.int32)

        # merge at entry state 0: within-word K + cross-word K
        merged = jnp.concatenate([top_in[:, 0, :], top_x], axis=1)  # (W, 2K)
        merged_bp = jnp.concatenate([bp_in[:, 0, :], bp_x], axis=1)
        m_top, m_idx = jax.lax.top_k(merged, K)
        m_bp = jnp.take_along_axis(merged_bp, m_idx, axis=1)

        new = top_in.at[:, 0, :].set(m_top) + lbt[:, :, None]
        bp = bp_in.at[:, 0, :].set(m_bp)
        if beam is not None:
            best = jnp.max(new)
            new = jnp.where(new >= best - beam, new, neg)
        if length is not None:
            keep = t < length
            new = jnp.where(keep, new, carry)
            bp = jnp.where(keep, bp, flat_ids)
        return new, bp

    ts = jnp.arange(1, T)
    final, bps = jax.lax.scan(step, init, (lb[1:], ts))
    return final.reshape(W * S, K), bps.reshape(T - 1, W * S, K)


@partial(jax.jit, static_argnames=())
def backtrace_path_device(backpointers: jax.Array, state: jax.Array, k: jax.Array):
    """Device-side backtrace: follow flat (state*K + k) pointers from the
    final (state, k) token through the (T-1, S_tot, K) backpointer lattice.
    Returns the (T,) state path — O(T) gathers on device instead of a host
    loop over a (T-1, S_tot, K) transfer."""
    K = backpointers.shape[-1]

    def step(carry, bp_t):
        s, kk = carry
        flat = bp_t[s, kk]
        return (flat // K, flat % K), s

    (s0, _), rest = jax.lax.scan(
        step, (state.astype(jnp.int32), k.astype(jnp.int32)),
        backpointers, reverse=True,
    )
    return jnp.concatenate([s0[None], rest], axis=0)  # (T,)


def backtrace_words(
    graph: ComposedGraph,
    final_scores: np.ndarray,
    backpointers: np.ndarray,
    length: int,
    rank: int = 0,
) -> tuple[float, list[int], list[tuple[int, int]]]:
    """Recover the rank-th best word sequence from a token-passing run.

    Returns (score, word_ids, word_spans) where word_spans are (start, end)
    frame ranges.  Ends in any word's exit state (word-loop semantics).
    """
    exit_states = np.asarray(graph.exit_states)
    s2w = np.asarray(graph.state_to_word)
    K = final_scores.shape[1]
    # best end tokens among exit states
    ends = [(final_scores[s, k], s, k) for s in exit_states for k in range(K)]
    ends.sort(key=lambda x: -x[0])
    score, state, k = ends[min(rank, len(ends) - 1)]

    path = [state]
    for t in range(length - 2, -1, -1):
        flat = backpointers[t, state, k]
        state, k = int(flat) // K, int(flat) % K
        path.append(state)
    path.reverse()

    entry_set = set(int(s) for s in np.asarray(graph.entry_states))
    exit_set = set(int(s) for s in exit_states)
    words, spans = [], []
    start = 0
    for t in range(1, length):
        # a word boundary is exactly an exit->entry arc: left-right internals
        # never reach an entry state except via its self-loop (from itself)
        crossed = (
            path[t] in entry_set
            and path[t - 1] in exit_set
            and path[t] != path[t - 1]
        )
        if crossed:
            words.append(int(s2w[path[start]]))
            spans.append((start, t))
            start = t
    words.append(int(s2w[path[start]]))
    spans.append((start, length))
    return float(score), words, spans


def _words_from_path(
    path: np.ndarray, S: int, exit_off=None
) -> tuple[list[int], list[tuple[int, int]]]:
    """Vectorized word-boundary extraction from a composed-state path: a
    boundary is exactly an exit -> entry(0) arc crossing (the rule of
    backtrace_words, without the host loop).  exit_off: exit state index
    within each word — scalar (default S - 1) or a (W,) per-word array
    for heterogeneous word lengths."""
    if exit_off is None:
        exit_off = S - 1
    p = np.asarray(path)
    crossed = np.zeros(len(p), dtype=bool)
    exit_off = np.asarray(exit_off)
    prev_exit = (
        exit_off[p[:-1] // S] if exit_off.ndim else exit_off
    ) if len(p) > 1 else exit_off
    if len(p) > 1:
        crossed[1:] = (p[1:] % S == 0) & (p[:-1] % S == prev_exit) & (p[1:] != p[:-1])
    starts = np.flatnonzero(np.concatenate([[True], crossed[1:]]))
    ends = np.append(starts[1:], len(p))
    words = (p[starts] // S).astype(int).tolist()
    return words, list(zip(starts.tolist(), ends.tolist()))


def decode_continuous(
    vocab: GmmHmm,
    frames: jax.Array,
    lm_logprobs: np.ndarray | None = None,
    n_best: int = 1,
    exit_logprob: float = float(np.log(0.1)),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial: np.ndarray | None = None,
    engine: str = "blocks",
    final_states: np.ndarray | None = None,
):
    """End-to-end continuous decode: compose word loop (unigram or bigram
    LM, see compose_word_loop), token-pass, return the N best
    (score, word_ids, spans) hypotheses.

    lm_initial: optional (W,) first-word log-probs forwarded to
    compose_word_loop — without it a bigram LM decode starts from a uniform
    first-word distribution.
    engine: "blocks" (default) — block-structured token passing,
    O(W S^2 K + W^2 K) per frame with device-side backtrace, scales to
    hundreds of words; "dense" — the (S_tot K, S_tot) expansion (small
    graphs / reference for equality tests)."""
    kwargs = dict(
        lm_logprobs=lm_logprobs,
        exit_logprob=exit_logprob,
        lm_scale=lm_scale,
        word_insertion_penalty=word_insertion_penalty,
        lm_initial=lm_initial,
    )
    log_b = composed_emissions(vocab, frames)
    T = log_b.shape[0]
    W = vocab.trans.shape[0]
    S = vocab.trans.shape[-1]

    if engine == "dense":
        if final_states is not None:
            raise ValueError(
                "decode_continuous: heterogeneous final_states require the "
                "blocks engine"
            )
        graph = compose_word_loop(vocab, **kwargs)
        final, bps = token_passing(graph, log_b, n_best=n_best)
        final = np.asarray(final)
        bps = np.asarray(bps)
        out = []
        seen = set()
        for r in range(n_best * len(np.asarray(graph.exit_states))):
            score, words, spans = backtrace_words(graph, final, bps, T, rank=r)
            key = tuple(words)
            if key not in seen and np.isfinite(score):
                seen.add(key)
                out.append((score, words, spans))
            if len(out) >= n_best:
                break
        return out

    graph = compose_word_loop_blocks(vocab, final_states=final_states, **kwargs)
    final, bps = token_passing_blocks(graph, log_b, n_best=n_best)
    fin = np.asarray(final)  # (W*S, K); bps stays on device for backtrace
    K = fin.shape[1]
    ex_off = (
        np.full(W, S - 1)
        if final_states is None
        else np.asarray(final_states)
    )
    exit_states = np.arange(W) * S + ex_off
    ends = [(fin[s, k], s, k) for s in exit_states for k in range(K)]
    ends.sort(key=lambda x: -x[0])
    out = []
    seen = set()
    for score, s, k in ends:
        if not np.isfinite(score):
            continue
        path = np.asarray(
            backtrace_path_device(
                bps, jnp.asarray(s, jnp.int32), jnp.asarray(k, jnp.int32)
            )
        )
        words, spans = _words_from_path(path[:T], S, exit_off=ex_off)
        key = tuple(words)
        if key not in seen:
            seen.add(key)
            out.append((float(score), words, spans))
        if len(out) >= n_best:
            break
    return out


@partial(jax.jit, static_argnames=("n_best", "n_cand"))
def _decode_batch_device(vocab, graph, feats, lengths, n_best, n_cand):
    """Batched word-loop Viterbi as one program: per-utterance composed
    emissions and block token passing, vmapped over the batch with length
    masks, then a batched backtrace of each utterance's n_cand best exit
    tokens.  feats: tuple of per-stream (B, T, D).  Returns (scores
    (B, n_cand) best first, state paths (T, B, n_cand))."""
    multi = len(feats) > 1
    W, S, _ = graph.log_trans.shape
    K = n_best

    def one(fs, length):
        log_b = composed_emissions(vocab, fs if multi else fs[0])
        return token_passing_blocks(graph, log_b, length, n_best=K)

    final, bps = jax.vmap(one)(feats, lengths)  # (B, N, K), (B, T-1, N, K)
    B = final.shape[0]
    ex_off = (
        jnp.full((W,), S - 1, jnp.int32)
        if graph.exit_states is None
        else graph.exit_states.astype(jnp.int32)
    )
    exit_rows = jnp.arange(W, dtype=jnp.int32) * S + ex_off
    # candidate c = w*K + k, the order decode_continuous ranks ties in
    ex_scores = final[:, exit_rows, :].reshape(B, W * K)
    top, cand = jax.lax.top_k(ex_scores, n_cand)  # (B, R)
    ids = exit_rows[cand // K] * K + cand % K  # flat token ids state*K + k

    def step(cur, bp_t):  # bp_t: (B, N*K)
        return jnp.take_along_axis(bp_t, cur, axis=1), cur

    bp_tb = jnp.swapaxes(bps.reshape(B, bps.shape[1], -1), 0, 1)
    first, rest = jax.lax.scan(step, ids, bp_tb, reverse=True)
    paths = jnp.concatenate([first[None], rest], axis=0) // K
    return top, paths


def decode_continuous_batch(
    vocab: GmmHmm,
    batch,
    lm_logprobs: np.ndarray | None = None,
    exit_logprob: float = float(np.log(0.1)),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial: np.ndarray | None = None,
    n_best: int = 1,
    final_states: np.ndarray | None = None,
):
    """Batched end-to-end continuous decode: every utterance of a padded
    batch decodes in ONE program — composed emissions and the block token
    passing engine (token_passing_blocks) vmapped over the batch with
    length masks, and one batched device backtrace.  Same results as
    decode_continuous run on each utterance alone (unigram or bigram LM,
    any n_best, heterogeneous word lengths via final_states).

    batch: UtteranceBatch (B, T, D), or a tuple of per-stream
    UtteranceBatch objects for MULTI-STREAM vocabularies (shared lengths,
    one feature set per stream, the reference's R2:331-339 contract;
    per-stream emissions sum in log space).

    Returns a list over utterances: (score, word_ids, word_spans) for
    n_best=1, else a list of up to n_best such tuples, best first (distinct
    word sequences, as decode_continuous dedupes them)."""
    if n_best < 1:
        raise ValueError("decode_continuous_batch: n_best must be >= 1")
    batches = batch if isinstance(batch, (tuple, list)) else (batch,)
    if len(batches) != len(vocab.streams) and len(batches) != 1:
        raise ValueError(
            f"{len(vocab.streams)} streams need {len(vocab.streams)} feature "
            f"batches, got {len(batches)}"
        )
    graph = compose_word_loop_blocks(
        vocab,
        lm_logprobs=lm_logprobs,
        exit_logprob=exit_logprob,
        lm_scale=lm_scale,
        word_insertion_penalty=word_insertion_penalty,
        lm_initial=lm_initial,
        final_states=final_states,
    )
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    # n_best=1 takes the best exit token; K-best dedupes word sequences, so
    # every exit token is a candidate (decode_continuous's rule)
    n_cand = 1 if n_best == 1 else W * n_best
    top, paths = _decode_batch_device(
        vocab, graph, tuple(b.features for b in batches),
        batches[0].lengths, n_best, n_cand,
    )
    top, paths = np.asarray(top), np.asarray(paths)
    ex_off = np.full(W, S - 1) if final_states is None else np.asarray(final_states)
    out = []
    for b, L in enumerate(np.asarray(batches[0].lengths)):
        hyps, seen = [], set()
        for r in range(n_cand if L > 0 else 0):
            score = float(top[b, r])
            if not np.isfinite(score):
                break
            words, spans = _words_from_path(paths[:L, b, r], S, exit_off=ex_off)
            if tuple(words) not in seen:
                seen.add(tuple(words))
                hyps.append((score, words, spans))
            if len(hyps) >= n_best:
                break
        if n_best == 1:
            out.append(hyps[0] if hyps else (float("-inf"), [], []))
        else:
            out.append(hyps)
    return out
