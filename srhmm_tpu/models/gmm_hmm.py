"""GMM-HMM parameter containers (JAX pytrees).

The reference stores a model as nested C structs (`struct mixture` /
`struct state`, /root/reference/train/source/hmm-full-fs/hmm_continuous_full_fs.c:55-66)
with one linked-list node per vocabulary word in the recognizer
(recognition-fs/recognition_continuous_fs.c:124-139).  This design
instead keeps every parameter as a dense array with explicit state / mixture /
coefficient axes, so that

  * the whole vocabulary stacks into one leading `word` axis and scoring all
    words is a single batched computation (vs. the reference's per-word linked
    list walk that re-reads the utterance from disk per word, R2:349), and
  * Gaussian parameters can be sharded over a `model` mesh axis and utterance
    batches over a `data` mesh axis with `jax.sharding`.

Covariance conventions follow the reference's on-disk contract: what is stored
is the **inverse** covariance together with the determinant of the *original*
covariance (hmm-full-fs:2378-2395) so recognition never inverts anything.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

FULL = "full"
DIAG = "diag"

# Numerical-contract constants carried over from the reference's semantics.
FINITE_PROBAB = 1.0e-5  # floor for mixture weights & cov diagonals (T1:38)
GAUS_INF_CLAMP = 1e20  # calc_gaus overflow clamp (T1:1880-1883)
BETA_INF_CLAMP = 1e200  # calc_beta overflow clamp (T1:1540)
ZERO_DET_THRESHOLD = 1e-20  # treat_zero_det trigger (T1:2242)


@pytree.dataclass
class GmmStream:
    """Gaussian-mixture emission parameters for one feature stream.

    Shapes (S = states, M = mixtures, D = feature dim):
      weights:  (..., S, M)     mixture coefficients
      means:    (..., S, M, D)
      inv_cov:  (..., S, M, D, D) for full covariance, (..., S, M, D) for diag
      det:      (..., S, M)     determinant of the ORIGINAL covariance
    Leading `...` axes (e.g. a vocabulary axis) are allowed everywhere.
    """

    weights: jax.Array
    means: jax.Array
    inv_cov: jax.Array
    det: jax.Array
    cov_type: str = pytree.static_field(default=FULL)
    # log |det|, the fast-path representation: raw determinants of real
    # speech covariances (1e20..1e40 in the fixtures) overflow float32, so
    # low-precision compute paths must normalize in log space.  None -> derive
    # from `det` on the fly (float64 storage path).
    log_det: Any = None

    @property
    def num_states(self) -> int:
        return self.weights.shape[-2]

    @property
    def num_mixtures(self) -> int:
        return self.weights.shape[-1]

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def log_abs_det(self) -> jax.Array:
        """log |Sigma| in a representation safe for low-precision compute."""
        if self.log_det is not None:
            return self.log_det
        return jnp.log(jnp.abs(self.det))

    def astype(self, dtype) -> "GmmStream":
        """Cast for compute.  `det` is converted to `log_det` BEFORE the cast
        so float32 compute never materializes the (overflowing) raw
        determinant."""
        return GmmStream(
            weights=self.weights.astype(dtype),
            means=self.means.astype(dtype),
            inv_cov=self.inv_cov.astype(dtype),
            det=self.det.astype(dtype),
            cov_type=self.cov_type,
            log_det=self.log_abs_det().astype(dtype),
        )


@pytree.dataclass
class GmmHmm:
    """A left-to-right continuous-density HMM for one word (or a stacked vocab).

    trans: (..., S, S) transition probabilities in probability domain (rows sum
    to 1 over the allowed band).  The initial distribution is implicit: the
    reference always starts in state 0 (`pi[0]=1`, T1:218-219); we keep that
    contract and do not store pi.
    """

    trans: jax.Array
    streams: tuple[GmmStream, ...]
    word: Any = pytree.static_field(default="")

    @property
    def num_states(self) -> int:
        return self.trans.shape[-1]

    @property
    def num_streams(self) -> int:
        return len(self.streams)

    @property
    def mixture_numbers(self) -> tuple[int, ...]:
        return tuple(s.num_mixtures for s in self.streams)

    @property
    def coef_numbers(self) -> tuple[int, ...]:
        return tuple(s.dim for s in self.streams)

    def log_trans(self) -> jax.Array:
        """log transition matrix with -inf for structurally-forbidden entries."""
        t = self.trans
        return jnp.where(t > 0, jnp.log(jnp.where(t > 0, t, 1.0)), -jnp.inf)

    def astype(self, dtype) -> "GmmHmm":
        """Cast for compute (determinants switch to log space, see
        GmmStream.astype).  Use this — not a raw tree.map — to lower
        precision."""
        return GmmHmm(
            trans=self.trans.astype(dtype),
            streams=tuple(s.astype(dtype) for s in self.streams),
            word=self.word,
        )


def concat_models(units: GmmHmm, ids: Sequence[int], word: str = "") -> GmmHmm:
    """Left-to-right concatenation of stacked unit models into ONE GmmHmm.

    units: a stacked (P, S, ...) inventory (e.g. materialized tied
    triphones); ids: the unit sequence.  The result has L*S states:
    block-diagonal transitions with a chain arc from unit k's exit state
    into unit k+1's entry carrying the exit state's self-loop mass — the
    compose_sequence / train.embedded._composed_log_trans convention
    (decode/continuous.py:150), so a word built here decodes identically
    to the forced-alignment graph of its unit sequence.  This is the
    tied-system -> decode-vocabulary materialization step: lexicon entries
    become ordinary GmmHmm word models that every scoring/decode path
    accepts.  The reference has no sub-word units at all (one whole-word
    model per .hmm, T1:62-66), so this seam is new surface."""
    ids = np.asarray(ids, np.int64)
    L = len(ids)
    S = units.trans.shape[-1]
    t = np.asarray(units.trans)[ids]  # (L, S, S)
    trans = np.zeros((L * S, L * S), t.dtype)
    for k in range(L):
        trans[k * S : (k + 1) * S, k * S : (k + 1) * S] = t[k]
        if k + 1 < L:
            trans[k * S + S - 1, (k + 1) * S] = t[k][S - 1, S - 1]

    def gather(a):
        a = np.asarray(a)[ids]  # (L, S, M, ...)
        return jnp.asarray(a.reshape(L * S, *a.shape[2:]))

    streams = tuple(
        GmmStream(
            weights=gather(st.weights),
            means=gather(st.means),
            inv_cov=gather(st.inv_cov),
            det=gather(st.det),
            cov_type=st.cov_type,
            log_det=None if st.log_det is None else gather(st.log_det),
        )
        for st in units.streams
    )
    return GmmHmm(trans=jnp.asarray(trans), streams=streams, word=word)


def stack_models(models: Sequence[GmmHmm]) -> GmmHmm:
    """Stack per-word models into a single GmmHmm with a leading vocab axis.

    All models must share (S, streams, M, D) shapes — true for any vocabulary
    trained with one CLI configuration, including the reference fixtures.
    Scoring the whole vocabulary then vmaps over the leading axis instead of
    walking a linked list (R2:341-369).
    """
    if not models:
        raise ValueError("stack_models: empty vocabulary")
    first = models[0]
    for m in models[1:]:
        if (
            m.num_states != first.num_states
            or m.mixture_numbers != first.mixture_numbers
            or m.coef_numbers != first.coef_numbers
        ):
            raise ValueError(
                "stack_models requires homogeneous model shapes; "
                f"{m.word}: {m.num_states}/{m.mixture_numbers}/{m.coef_numbers} vs "
                f"{first.word}: {first.num_states}/{first.mixture_numbers}/{first.coef_numbers}"
            )
    # `word` is static metadata and differs per model, which would make the
    # pytree structures unequal — blank it before mapping over leaves.
    bare = [m.replace(word="") for m in models]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *bare)
    words = tuple(m.word for m in models)
    return stacked.replace(word=words)


def pad_stack_models(models: Sequence[GmmHmm]) -> tuple[GmmHmm, jax.Array]:
    """Stack per-word models of HETEROGENEOUS shapes into one GmmHmm.

    The reference recognizer walks a linked list whose nodes carry their own
    states_number / mixture_number read from each .hmm
    (recognition-fs/recognition_continuous_fs.c:201-245, reading_model
    :595-715), so a vocabulary can freely mix e.g. 5-state and 8-state
    models.  The dense layout gets the same capability by padding every
    model to the max (S, M) per stream:

      * filler STATES are unreachable: no arcs from real states reach them
        (their trans rows are self-loop 1.0 only so rows stay stochastic),
        hence their (log-)alpha is identically -inf / 0 and both scoring
        modes are unaffected — but the FINAL state of a padded word is no
        longer index S_max-1, so final-state scoring must gather the
        returned `final_states` indices;
      * filler MIXTURES get weight 0 (log -inf / prob 0 contribution) with
        benign identity covariances.

    Feature dims must match across models (all models of one stream score
    the same feature file).  Returns (stacked GmmHmm, (W,) int32 final-state
    indices).  Homogeneous inputs reduce to stack_models + full final index.
    """
    if not models:
        raise ValueError("pad_stack_models: empty vocabulary")
    n_streams = models[0].num_streams
    for m in models[1:]:
        if m.num_streams != n_streams:
            raise ValueError("pad_stack_models: stream counts differ")
        if m.coef_numbers != models[0].coef_numbers:
            raise ValueError(
                "pad_stack_models: feature dims differ "
                f"({m.word}: {m.coef_numbers} vs {models[0].coef_numbers})"
            )
    s_max = max(m.num_states for m in models)
    m_max = [
        max(m.streams[p].num_mixtures for m in models) for p in range(n_streams)
    ]

    padded = []
    for m in models:
        S = m.num_states
        dtype = np.asarray(m.trans).dtype
        trans = np.zeros((s_max, s_max), dtype)
        trans[:S, :S] = np.asarray(m.trans)
        for s in range(S, s_max):
            trans[s, s] = 1.0  # unreachable self-loop keeps rows stochastic
        new_streams = []
        for p, st in enumerate(m.streams):
            M, D = st.num_mixtures, st.dim
            Mx = m_max[p]
            w = np.zeros((s_max, Mx), dtype)
            w[:S, :M] = np.asarray(st.weights)
            w[S:, 0] = 1.0  # filler states: benign unit weight on mixture 0
            mu = np.zeros((s_max, Mx, D), dtype)
            mu[:S, :M] = np.asarray(st.means)
            det = np.ones((s_max, Mx), dtype)
            det[:S, :M] = np.asarray(st.det)
            ld = np.zeros((s_max, Mx), dtype)  # filler: log|det| of 1
            ld[:S, :M] = np.asarray(st.log_abs_det())
            if st.cov_type == FULL:
                ic = np.tile(np.eye(D, dtype=dtype), (s_max, Mx, 1, 1))
                ic[:S, :M] = np.asarray(st.inv_cov)
            else:
                ic = np.ones((s_max, Mx, D), dtype)
                ic[:S, :M] = np.asarray(st.inv_cov)
            new_streams.append(
                GmmStream(
                    weights=jnp.asarray(w),
                    means=jnp.asarray(mu),
                    inv_cov=jnp.asarray(ic),
                    det=jnp.asarray(det),
                    cov_type=st.cov_type,
                    log_det=jnp.asarray(ld),
                )
            )
        padded.append(
            GmmHmm(trans=jnp.asarray(trans), streams=tuple(new_streams), word=m.word)
        )
    stacked = stack_models(padded)
    final_states = jnp.asarray([m.num_states - 1 for m in models], jnp.int32)
    return stacked, final_states


def init_left_right_trans(
    states_number: int, delta: int = 1, dtype=jnp.float64
) -> jax.Array:
    """Uniform banded left-right transition matrix.

    Replicates `init_transition_probab` (T1:772-791): row i is uniform over
    states [i, min(i+delta, S-1)], zero elsewhere.
    """
    i = np.arange(states_number)[:, None]
    j = np.arange(states_number)[None, :]
    allowed = (j >= i) & (j <= i + delta)
    width = np.minimum(delta + 1, states_number - np.arange(states_number))
    trans = np.where(allowed, 1.0 / width[:, None], 0.0)
    return jnp.asarray(trans, dtype=dtype)


def validate_model(model: GmmHmm, atol: float = 1e-3) -> list[str]:
    """Stochasticity sanity checks mirroring the reference's printf warnings
    (row sums T1:1926, mixture-coefficient sums T1:1997-1998). Returns a list
    of human-readable violations (empty = OK)."""
    problems = []
    row_sums = np.asarray(model.trans).sum(axis=-1)
    bad = np.abs(row_sums - 1.0) > atol
    if bad.any():
        problems.append(f"transition row sums off: {row_sums[bad]}")
    for si, s in enumerate(model.streams):
        w_sums = np.asarray(s.weights).sum(axis=-1)
        badw = np.abs(w_sums - 1.0) > atol
        if badw.any():
            problems.append(f"stream {si} mixture weight sums off: {w_sums[badw]}")
    return problems


def denormalize_stream(stream: GmmStream, mean, std) -> GmmStream:
    """Map a stream trained on y = (x - mean)/std back to raw feature
    space (the exact inverse affine transform):

        mu_x = std * mu_y + mean
        Sigma_x = S Sigma_y S          (S = diag(std))
        Sigma_x^{-1} = S^{-1} Sigma_y^{-1} S^{-1}
        log|Sigma_x| = log|Sigma_y| + 2 sum log std

    Together with features.frontend.global_cmvn_stats this makes the fast
    trainer's normalized-space EM export raw-space .hmm models."""
    import numpy as np

    m = jnp.asarray(mean, stream.means.dtype)
    s = jnp.asarray(std, stream.means.dtype)
    means = stream.means * s + m
    if stream.cov_type == FULL:
        inv_cov = stream.inv_cov / (s[:, None] * s[None, :])
    else:
        inv_cov = stream.inv_cov / (s * s)
    # log-space determinant update avoids overflowing the linear det
    log_det = stream.log_abs_det() + 2.0 * jnp.sum(
        jnp.log(jnp.asarray(std, jnp.float64)).astype(stream.means.dtype)
    )
    return stream.replace(
        means=means,
        inv_cov=inv_cov,
        det=jnp.exp(log_det),
        log_det=log_det,
    )


def denormalize_model(model: GmmHmm, stats) -> GmmHmm:
    """denormalize_stream over every stream; stats: list of (mean, std)
    per stream (or a single pair for single-stream models)."""
    if not isinstance(stats, list):
        stats = [stats]
    return model.replace(
        streams=tuple(
            denormalize_stream(st, m, s)
            for st, (m, s) in zip(model.streams, stats)
        )
    )
