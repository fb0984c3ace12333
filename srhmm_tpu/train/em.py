"""Fast-path Baum-Welch EM: log-space, batched, jitted, mesh-shardable.

Redesign of the reference EM loop (T1:223-346) for accelerator execution:

* whole utterance batch resident on device as a padded (B, T, D) array —
  no per-utterance disk re-reads (the reference re-reads every .perfil twice
  per iteration, T1:259/287);
* one E-step (`e_step`): emission and occupancy statistics as GEMM-shaped
  contractions at the one matmul precision of ops/backend.py, forward/
  backward as log-space lattices — the XLA `lax.scan` recursions, or on a
  GPU the Triton lattice kernels (ops/lattice_triton.py), picked by
  ops/backend.py;
* `em_train_scan` runs N iterations as ONE jitted lax.scan (no
  per-iteration program launches/host syncs — the production fixed-budget
  trainer); `em_train_scan_sharded` runs the same scan data-parallel under
  shard_map with the statistics psum-reduced over the `data` axis;
  `train_fast` keeps the reference's per-iteration convergence rule
  (T1:306-346);
* covariance statistics accumulate raw moments (sum gamma, sum gamma x,
  sum gamma x x^T) and the M-step recovers the reference's
  residual-about-PRE-update-means covariance (T1:1744-1750) through the
  moment identity  sum g (x-mu0)(x-mu0)^T = XX - mu0 a^T - a mu0^T + w mu0 mu0^T,
  keeping the E-step free of (T, S, M, D, D) intermediates.

Validated against train/em_parity.py (the reference-exact oracle) in
tests/test_em_fast.py; kernel/XLA equivalence in tests/test_lattice_triton.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from ..utils import pytree

from ..io.dataset import UtteranceBatch
from ..models.gmm_hmm import FINITE_PROBAB, FULL, GmmHmm, GmmStream
from ..ops import backend
from ..ops.backend import PRECISION
from ..ops.emission import log_mixture_posteriors
from ..ops.forward_backward import log_backward_full, log_forward_full


@pytree.dataclass
class StreamStats:
    w: jax.Array  # (S, M)        sum_t gamma_m
    x: jax.Array  # (S, M, D)     sum_t gamma_m * x_t
    xx: jax.Array  # (S, M, D, D) full | (S, M, D) diag: second moment


@pytree.dataclass
class SuffStats:
    num_trans: jax.Array  # (S, S)
    den_trans: jax.Array  # (S,)
    den_mix: jax.Array  # (S,)
    streams: tuple[StreamStats, ...]
    log_prob: jax.Array  # scalar: sum over utterances of final-state log P
    num_valid: jax.Array  # scalar: utterances with finite log P


def gmm_moment_stats(gm, feats, cov_type, stat_in=None, origin=None):
    """Occupancy-weighted GMM moment statistics as single-pass GEMMs — the
    one implementation behind the isolated (e_step), lane-major, embedded,
    and tied E-steps.

    gm: (N, G, M) mixture occupancy (gamma * posterior) over N frames and
    G groups (states, transcript positions, or senones); feats: (N, D).
    Returns (w (G, M), x (G, M, D), xx (G, M, D, D) full | (G, M, D) diag)
    in feature space.

    The big (N, G, M) tensor is read from HBM ONCE for all statistics: the
    diag path contracts the fused [y, y^2, 1] lift in one GEMM; full
    covariance needs a second contraction for the (D, D) moment.

    stat_in: optional low-precision input dtype (bf16) for the GEMMs (f32
    accumulation); origin: optional (D,) shift o — moments are
    computed about o and exactly unshifted via
    sum g x = sum g y + o sum g and the binomial identity for the second
    moment, so low-precision rounding is relative to CENTERED magnitudes
    (see _per_utterance_stats' rounding-error note)."""
    dtype = feats.dtype
    D = feats.shape[-1]
    si = stat_in or dtype
    ones = jnp.ones_like(feats[:, :1])
    o = jnp.zeros((D,), dtype) if origin is None else origin
    y = feats - o
    gmc = gm.astype(si)
    if cov_type == FULL:
        # one GEMM pass over gm for (y, w); the (D, D) moment needs its
        # own contraction
        smk = jnp.einsum(
            "ngm,nk->gmk",
            gmc,
            jnp.concatenate([y, ones], -1).astype(si),
            preferred_element_type=dtype,
            precision=PRECISION,
        )
        ys, w = smk[..., :D], smk[..., D]
        yy = jnp.einsum(
            "ngm,nd,ne->gmde",
            gmc,
            y.astype(si),
            y.astype(si),
            preferred_element_type=dtype,
            precision=PRECISION,
        )
        x = ys + o * w[..., None]
        xx = (
            yy
            + o[:, None] * ys[..., None, :]
            + ys[..., :, None] * o[None, :]
            + (o[:, None] * o[None, :]) * w[..., None, None]
        )
    else:
        smk = jnp.einsum(
            "ngm,nk->gmk",
            gmc,
            jnp.concatenate([y, y * y, ones], -1).astype(si),
            preferred_element_type=dtype,
            precision=PRECISION,
        )
        ys, yy, w = smk[..., :D], smk[..., D : 2 * D], smk[..., 2 * D]
        x = ys + o * w[..., None]
        xx = yy + 2.0 * o * ys + (o * o) * w[..., None]
    return w.astype(dtype), x.astype(dtype), xx.astype(dtype)


def _per_utterance_stats(
    model: GmmHmm, feats, length: jax.Array, bf16_stats: bool = False
):
    """E-step statistics for one padded utterance.

    feats: (T, D) array for single-stream models, or a tuple of per-stream
    (T, D_p) arrays (the reference supports up to 6 parameter streams with
    distinct feature files per stream, T1:41/T1:256-270; all streams of an
    utterance must share the frame count — the reference silently assumes
    this too, T1:274).

    bf16_stats: feed the moment GEMMs bf16 inputs (f32 accumulation).  bf16xbf16 products are exact in f32, so the only error is input
    rounding (<=2^-9 relative) — for a 1.5x faster stat contraction and half
    the gm/lift HBM traffic.

    Rounding-error note: the M-step recovers covariances through the moment
    identity (sum g x^2 - 2 mu0 sum g x + mu0^2 w), which amplifies raw-moment
    rounding by ~mean^2/variance — percent-level variance error for features
    with magnitudes in the thousands (the reference fixtures) despite tiny
    raw-moment error.  To kill the amplification, the bf16 path computes
    moments about a SHIFTED ORIGIN (the stream's mean of means per dim):
    features are centered BEFORE the bf16 cast, so the rounding is relative
    to the centered magnitude (~ state spread + sigma), and the exact f32
    unshift below restores original-space moments.  Residual stat error is
    then ~2^-9 relative to centered scales — hardware-measured ~2e-6 relative
    at the headline shape with unit-variance data.  Keep False for
    parity-sensitive runs.
    """
    feats_per_stream = _streams_of(model, feats)
    dtype = feats_per_stream[0].dtype
    log_trans = model.log_trans().astype(dtype)
    log_b, posts = _emissions(model, feats_per_stream)
    la = log_forward_full(log_b, log_trans, length)
    lbw = log_backward_full(log_b, log_trans, length)
    return _lattice_stats(
        model, feats_per_stream, log_b, posts, la, lbw, length, bf16_stats
    )


def _streams_of(model: GmmHmm, feats) -> tuple:
    """Per-stream frames: a tuple as given, or one array shared by every
    stream."""
    return feats if isinstance(feats, tuple) else (feats,) * len(model.streams)


def _emissions(model: GmmHmm, feats_per_stream):
    """(log b (T, S) summed over streams, per-stream mixture posteriors)."""
    log_b = None
    posts = []
    for stream, sf in zip(model.streams, feats_per_stream):
        lb_s, post_s = log_mixture_posteriors(sf, stream)
        posts.append(post_s)
        log_b = lb_s if log_b is None else log_b + lb_s
    return log_b, tuple(posts)


def _lattice_stats(
    model: GmmHmm, feats_per_stream, log_b, posts, la, lbw, length, bf16_stats
) -> SuffStats:
    """One utterance's sufficient statistics from its emissions and its
    forward/backward lattices (T, S)."""
    S = model.num_states
    dtype = feats_per_stream[0].dtype
    log_trans = model.log_trans().astype(dtype)
    log_z = la[-1, S - 1]  # rows at t >= length repeat the last valid row
    valid = jnp.isfinite(log_z) & (length > 0)
    safe_z = jnp.where(valid, log_z, 0.0)

    T = feats_per_stream[0].shape[0]
    t_idx = jnp.arange(T)
    frame_mask = (t_idx < length).astype(dtype)

    lgamma = la + lbw - safe_z
    gamma = jnp.exp(jnp.minimum(lgamma, 0.0)) * frame_mask[:, None]  # (T, S)

    # banded xi statistics (calc_transition_probab T1:1609-1647)
    xi_mask = (t_idx[:-1] < length - 1).astype(dtype)
    log_xi = (
        la[:-1, :, None]
        + log_trans[None, :, :]
        + (log_b[1:] + lbw[1:])[:, None, :]
        - safe_z
    )
    xi = jnp.exp(jnp.minimum(log_xi, 0.0)) * xi_mask[:, None, None]
    num_trans = xi.sum(0)
    den_trans = (gamma[:-1] * xi_mask[:, None]).sum(0)
    den_mix = gamma.sum(0)

    stat_in = jnp.bfloat16 if bf16_stats else dtype
    stream_stats = []
    for stream, post, sf in zip(model.streams, posts, feats_per_stream):
        gm = gamma[:, :, None] * post  # (T, S, M)
        # shifted origin for bf16: center features on the stream's mean of
        # means so the bf16 rounding is relative to centered magnitudes (see
        # _per_utterance_stats); o == None keeps the f32 path exact
        o = (
            jnp.mean(stream.means.astype(dtype), axis=(0, 1))
            if bf16_stats
            else None
        )
        w, x, xx = gmm_moment_stats(
            gm, sf, stream.cov_type, stat_in=stat_in, origin=o
        )
        stream_stats.append(StreamStats(w=w, x=x, xx=xx))

    zero = lambda a: jnp.where(valid, a, jnp.zeros_like(a))
    return SuffStats(
        num_trans=zero(num_trans),
        den_trans=zero(den_trans),
        den_mix=zero(den_mix),
        streams=tuple(
            StreamStats(w=zero(s.w), x=zero(s.x), xx=zero(s.xx))
            for s in stream_stats
        ),
        log_prob=jnp.where(valid, log_z, 0.0),
        num_valid=valid.astype(dtype),
    )


def e_step(
    model: GmmHmm,
    batch,
    bf16_stats: bool = False,
    lattice: str | None = None,
    interpret: bool = False,
) -> SuffStats:
    """Batched E-step: per-utterance statistics summed over the batch axis.
    Under GSPMD with the batch sharded on `data`, the sum is an all-reduce.

    batch: an UtteranceBatch, or a tuple of UtteranceBatch (one per stream,
    equal lengths) for multi-stream models.
    bf16_stats: bf16-input moment GEMMs (see _per_utterance_stats).
    lattice: None picks the forward/backward implementation from the
    platform (ops/backend.py); "xla" runs the vmapped lax.scan recursions,
    "triton" the lane-major kernels of ops/lattice_triton.py (interpret:
    run them in the Pallas interpreter — tests only).
    """
    batches = batch if isinstance(batch, tuple) else (batch,)
    feats = tuple(b.features for b in batches)
    lengths = batches[0].lengths
    multi = isinstance(batch, tuple)
    per = lambda fs: tuple(fs) if multi else fs[0]
    if lattice is None:
        lattice = backend.lattice_impl(*feats)

    if lattice == backend.XLA:
        per_utt = jax.vmap(
            lambda fs, l: _per_utterance_stats(model, per(fs), l, bf16_stats)
        )(feats, lengths)
    else:
        from ..ops.lattice_triton import backward_lattice, forward_lattice

        log_b, posts = jax.vmap(
            lambda fs: _emissions(model, _streams_of(model, per(fs)))
        )(feats)  # (B, T, S), per-stream (B, T, S, M)
        log_trans = model.log_trans().astype(log_b.dtype)
        lb_tsb = jnp.transpose(log_b, (1, 2, 0))
        la = forward_lattice(lb_tsb, log_trans, lengths, interpret=interpret)
        lbw = backward_lattice(lb_tsb, log_trans, lengths, interpret=interpret)
        to_bts = lambda a: jnp.transpose(a, (2, 0, 1))
        per_utt = jax.vmap(
            lambda fs, lb, po, a, b, l: _lattice_stats(
                model, _streams_of(model, per(fs)), lb, po, a, b, l, bf16_stats
            )
        )(feats, log_b, posts, to_bts(la), to_bts(lbw), lengths)
    return jax.tree.map(lambda a: a.sum(0), per_utt)


def update_stream(
    stream: GmmStream,
    st: StreamStats,
    den_mix: jax.Array,
    var_floor: float = 0.0,
    abs_floor=None,
    zero_det_threshold=None,
) -> GmmStream:
    """Emission-parameter update for one stream from its sufficient stats
    (the GMM half of the M-step; shared by isolated, embedded, and
    tied-state training).  Leading axes of the arrays are arbitrary — (S,)
    states, (P, S), or (N,) senones.

    abs_floor: optional replacement for the reference's ABSOLUTE variance
    floor FINITE_PROBAB (T1:1975-1977), scalar or per-dim (D,).  Training
    in affine-normalized feature space (--cmvn global) passes
    FINITE_PROBAB / std^2 so the floor acts at exactly the raw-space
    magnitudes — the absolute 1e-5 floor is the one EM quantity that is
    NOT affine-equivariant (in normalized space it floors real variances
    and costs >1e3 nats on the fixtures; hardware-debugged round 3)."""
    dtype = stream.means.dtype
    base_floor = (
        max(FINITE_PROBAB, var_floor)
        if abs_floor is None
        else jnp.maximum(jnp.asarray(abs_floor, dtype), var_floor)
    )
    touched = (den_mix > 0)[..., None]
    w_safe = jnp.where(st.w > 0, st.w, 1.0)

    weights = jnp.where(
        touched, st.w / jnp.where(den_mix > 0, den_mix, 1.0)[..., None],
        stream.weights,
    )
    weights = jnp.maximum(weights, FINITE_PROBAB)
    weights = weights / weights.sum(-1, keepdims=True)

    mu0 = stream.means
    means = jnp.where(touched[..., None], st.x / w_safe[..., None], mu0)

    old_log_det = stream.log_abs_det()
    if stream.cov_type == FULL:
        a = st.x
        cov = (
            st.xx
            - mu0[..., :, None] * a[..., None, :]
            - a[..., :, None] * mu0[..., None, :]
            + st.w[..., None, None] * mu0[..., :, None] * mu0[..., None, :]
        ) / w_safe[..., None, None]
        D = cov.shape[-1]
        eye = jnp.eye(D, dtype=dtype)
        diag = jnp.diagonal(cov, axis1=-2, axis2=-1)
        floored = jnp.maximum(diag, base_floor)
        cov = cov + (floored - diag)[..., None] * eye
        inv_new, log_det_new = _batched_inv_logdet(cov)
        inv = jnp.where(touched[..., None, None], inv_new, stream.inv_cov)
        log_det = jnp.where(touched, log_det_new, old_log_det)
    else:
        cov = (
            st.xx - 2.0 * mu0 * st.x + st.w[..., None] * mu0 * mu0
        ) / w_safe[..., None]
        cov = jnp.maximum(cov, base_floor)
        inv_new = 1.0 / cov
        log_det_new = jnp.sum(jnp.log(cov), axis=-1)
        inv = jnp.where(touched[..., None], inv_new, stream.inv_cov)
        log_det = jnp.where(touched, log_det_new, old_log_det)

    zd = _LOG_ZERO_DET if zero_det_threshold is None else zero_det_threshold
    weights, means, inv, log_det = _repair_degenerate(
        weights, means, inv, log_det, stream.cov_type, zd
    )
    if stream.cov_type == FULL:
        # Last-resort PSD fallback (beyond the reference): if a mixture's
        # covariance is still not invertible after donor repair (e.g. the
        # whole state collapsed), fall back to its diagonal covariance —
        # always PSD after flooring.  HTK-style robustness for
        # over-parameterized models; unreachable in the fixture regime.
        still_bad = ~jnp.isfinite(log_det) | (log_det < zd)
        diag_inv = 1.0 / floored
        eye_d = jnp.eye(floored.shape[-1], dtype=dtype)
        inv = jnp.where(
            still_bad[..., None, None], diag_inv[..., None] * eye_d, inv
        )
        log_det = jnp.where(
            still_bad, jnp.sum(jnp.log(floored), axis=-1), log_det
        )
    return GmmStream(
        weights=weights,
        means=means,
        inv_cov=inv,
        # linear det kept for the .hmm export contract; may overflow in f32
        # (log_det is the authoritative fast-path value)
        det=jnp.exp(log_det),
        cov_type=stream.cov_type,
        log_det=log_det,
    )


def m_step(
    model: GmmHmm,
    stats: SuffStats,
    var_floor: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
) -> GmmHmm:
    """Reference-semantics parameter update (T1:1907-2000 + re-inversion),
    vectorized over (S, M).

    var_floor: minimum variance (covariance diagonal), on top of the
    reference's absolute FINITE_PROBAB floor.  The reference floors at 1e-5
    regardless of feature scale (T1:1975-1977), which under-regularizes
    features with magnitudes in the thousands (the fixture profiles); a
    relative floor keeps over-parameterized mixtures PSD.  0.0 = reference
    semantics.

    Degenerate-covariance repair (treat_zero_det, T1:2226-2265) is
    vectorized: every mixture whose determinant collapses below 1e-20 is
    re-seeded from its state's largest-determinant mixture (+/-5% mean split,
    halved weight).  The C re-seeds from successive donors; with one donor
    per state the behaviors coincide, which covers the non-pathological case.
    """
    S = model.num_states
    dtype = model.trans.dtype

    # structural mask from the model's own support: EM preserves zeros (xi is
    # zero wherever trans is), so this works for any banding (delta >= 1),
    # unlike a hard-coded delta band
    band = (model.trans > 0).astype(dtype)
    den = stats.den_trans
    trans_new = jnp.where(
        (den > 0)[:, None],
        band * stats.num_trans / jnp.where(den > 0, den, 1.0)[:, None],
        model.trans,
    )

    new_streams = [
        update_stream(
            stream, st, stats.den_mix, var_floor,
            None if abs_floors is None else abs_floors[i],
            None if zero_det_thresholds is None else zero_det_thresholds[i],
        )
        for i, (stream, st) in enumerate(zip(model.streams, stats.streams))
    ]

    return model.replace(trans=trans_new, streams=tuple(new_streams))


def _batched_inv_logdet(cov: jax.Array):
    """(…, D, D) SPD inverse + log-determinant via Cholesky (the fast-path
    replacement for the reference's LDL^T, ops/linalg_parity.py).  log-space
    determinant avoids f32 overflow on real speech covariances."""
    L = jnp.linalg.cholesky(cov)
    diag_l = jnp.diagonal(L, axis1=-2, axis2=-1)
    log_det = 2.0 * jnp.sum(jnp.log(diag_l), axis=-1)
    D = cov.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(D, dtype=cov.dtype), cov.shape)
    l_inv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    inv = jnp.einsum(
        "...ki,...kj->...ij", l_inv, l_inv, preferred_element_type=cov.dtype,
        precision=PRECISION,
    )
    bad = ~jnp.isfinite(log_det)
    log_det = jnp.where(bad, -jnp.inf, log_det)
    inv = jnp.where(bad[..., None, None], 0.0, inv)
    return inv, log_det


_LOG_ZERO_DET = -46.0517018598809136  # log(1e-20), treat_zero_det trigger


def _repair_degenerate(weights, means, inv, log_det, cov_type, zd=_LOG_ZERO_DET):
    """Vectorized treat_zero_det (T1:2226-2265): re-seed collapsed mixtures
    from the state's largest-determinant mixture."""
    bad = log_det < zd  # (S, M)
    any_bad = bad.any(-1)
    donor = jnp.argmax(log_det, axis=-1)  # (S,)
    take = lambda a: jnp.take_along_axis(
        a, donor[:, None].reshape((-1,) + (1,) * (a.ndim - 1)), axis=1
    )
    d_means, d_inv, d_ld, d_w = (take(means), take(inv), take(log_det), take(weights))
    means = jnp.where(bad[..., None], d_means * 1.05, means)
    # donor mean shrinks when it actually donated
    donated = any_bad[:, None] & (jnp.arange(means.shape[1])[None] == donor[:, None])
    means = jnp.where(donated[..., None], means * 0.95, means)
    if cov_type == FULL:
        inv = jnp.where(bad[..., None, None], d_inv, inv)
    else:
        inv = jnp.where(bad[..., None], d_inv, inv)
    log_det = jnp.where(bad, d_ld, log_det)
    weights = jnp.where(donated, weights / 2.0, weights)
    weights = jnp.where(bad, d_w / 2.0, weights)
    weights = weights / weights.sum(-1, keepdims=True)
    return weights, means, inv, log_det


def _with_log_det(model: GmmHmm) -> GmmHmm:
    """Ensure every stream carries a materialized log_det array (scan
    carries need a stable pytree structure; m_step always emits one)."""
    if all(s.log_det is not None for s in model.streams):
        return model
    return model.replace(
        streams=tuple(
            s if s.log_det is not None else s.replace(log_det=s.log_abs_det())
            for s in model.streams
        )
    )


_m_step_jit = jax.jit(m_step, static_argnames=("var_floor",))


def _lattice_for(batch) -> str:
    """Lattice implementation for this batch (ops/backend.py decides)."""
    parts = batch if isinstance(batch, tuple) else (batch,)
    return backend.lattice_impl(*(b.features for b in parts))


@partial(jax.jit, static_argnames=("var_floor", "bf16_stats", "lattice"))
def _em_step(model, batch, var_floor=0.0, bf16_stats=False, lattice=backend.XLA):
    stats = e_step(model, batch, bf16_stats=bf16_stats, lattice=lattice)
    new_model = m_step(model, stats, var_floor=var_floor)
    return new_model, stats.log_prob, stats.num_valid


def em_step(
    model: GmmHmm, batch, var_floor: float = 0.0, bf16_stats: bool = False
):
    """One full EM iteration: (new_model, total_log_prob, num_valid).

    bf16_stats=True feeds the moment GEMMs bf16 inputs with f32
    accumulation (shifted-origin moments keep the stat error ~2e-6; see
    _per_utterance_stats).  Inputs sharded over several devices run under
    GSPMD on the XLA lattices (XLA inserts the all-reduces)."""
    return _em_step(model, batch, var_floor, bf16_stats, _lattice_for(batch))


def em_step_time_sharded(model, batch, mesh, var_floor: float = 0.0, axis="time"):
    """One EM iteration with the TIME axis sequence-parallel across devices
    (parallel/sequence.py): E-step statistics are psum-reduced over the
    `axis` mesh axis, M-step runs replicated.  Use when single utterances
    outgrow one device's memory; otherwise em_step (data-parallel) is
    faster."""
    from ..parallel.sequence import e_step_time_sharded

    stats = e_step_time_sharded(model, batch, mesh, axis=axis)
    new_model = _m_step_jit(model, stats, var_floor=var_floor)
    return new_model, stats.log_prob, stats.num_valid


def _scan_em(model, batch, n_iters, var_floor, abs_floors, zero_det_thresholds,
             lattice, axis=None):
    """The N-iteration EM scan body shared by the single-device and the
    data-parallel trainers; with `axis` the statistics psum over that
    mesh axis before the (replicated) M-step."""

    def step(m, _):
        st = e_step(m, batch, lattice=lattice)
        if axis is not None:
            st = jax.tree.map(lambda a: jax.lax.psum(a, axis), st)
        new = m_step(
            m, st, var_floor=var_floor, abs_floors=abs_floors,
            zero_det_thresholds=zero_det_thresholds,
        )
        return new, (st.log_prob, st.num_valid)

    final, (lps, nvs) = jax.lax.scan(step, model, None, length=n_iters)
    return final, lps, nvs


@partial(jax.jit, static_argnames=("n_iters", "var_floor", "lattice"))
def _em_train_scan(model, batch, n_iters, var_floor, abs_floors,
                   zero_det_thresholds, lattice):
    return _scan_em(
        model, batch, n_iters, var_floor, abs_floors, zero_det_thresholds,
        lattice,
    )


def em_train_scan(
    model: GmmHmm,
    batch,
    n_iters: int,
    var_floor: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
    lattice: str | None = None,
):
    """N EM iterations as ONE jitted lax.scan — no per-iteration program
    launches or host syncs (the reference's convergence check forces a host
    round-trip per iteration; production training at a fixed iteration
    budget doesn't need it).  Returns (final model, (n_iters,) log-prob
    history, (n_iters,) num_valid history).

    lattice: None picks the lattice implementation from the platform
    (ops/backend.py); "xla" or "triton" forces one (A/B measurement)."""
    # m_step always emits log_det arrays; a None input would change the
    # scan carry's pytree structure mid-loop
    model = _with_log_det(model)
    return _em_train_scan(
        model, batch, n_iters, var_floor, abs_floors, zero_det_thresholds,
        lattice or _lattice_for(batch),
    )


def _put_batch(batch: UtteranceBatch, mesh, axis):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return UtteranceBatch(
        features=jax.device_put(
            batch.features, NamedSharding(mesh, P(axis, None, None))
        ),
        lengths=jax.device_put(batch.lengths, NamedSharding(mesh, P(axis))),
    )


def e_step_sharded(
    model: GmmHmm, batch: UtteranceBatch, mesh, axis: str = "data"
) -> SuffStats:
    """Data-parallel E-step: each device runs the production E-step on its
    batch shard and the statistics psum over `axis` (EM statistics are
    linear in the data).  The batch axis must divide the mesh axis; the
    model is replicated."""
    lattice = backend.lattice_impl()
    fn = _jitted_e_step_sharded(mesh, axis, lattice, jax.tree.structure(model))
    return fn(model, _put_batch(batch, mesh, axis))


@lru_cache(maxsize=32)
def _jitted_e_step_sharded(mesh, axis, lattice, model_treedef):
    from jax.sharding import PartitionSpec as P

    model_spec = jax.tree.unflatten(
        model_treedef, [P()] * model_treedef.num_leaves
    )

    def shard_fn(model, batch):
        st = e_step(model, batch, lattice=lattice)
        return jax.tree.map(lambda a: jax.lax.psum(a, axis), st)

    batch_spec = UtteranceBatch(features=P(axis, None, None), lengths=P(axis))
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(model_spec, batch_spec),
        out_specs=P(),
        # pallas_call outputs carry no varying-mesh-axes annotation; the
        # psum establishes the replicated out_specs by construction
        check_vma=False,
    )
    return jax.jit(fn)


def em_train_scan_sharded(
    model: GmmHmm,
    batch: UtteranceBatch,
    n_iters: int,
    mesh,
    axis: str = "data",
    var_floor: float = 0.0,
):
    """N DATA-PARALLEL EM iterations as ONE jitted shard_map(lax.scan).

    The whole N-iteration scan lives INSIDE the shard_map: each device
    runs the production E-step on its batch shard, the sufficient
    statistics psum over `axis` (EM statistics are linear in the data),
    and every device computes the identical M-step from the reduced
    statistics, keeping the scan carry replicated by construction.

    Returns (final model, (n_iters,) log-prob history, (n_iters,)
    num_valid history) — the trajectory of the single-device
    em_train_scan up to the order of the cross-device sum.

    The batch axis must divide the mesh `axis`; the model is replicated.
    """
    model = _with_log_det(model)
    fn = _jitted_sharded_scan(
        mesh, axis, n_iters, var_floor, backend.lattice_impl(),
        jax.tree.structure(model),
    )
    return fn(model, _put_batch(batch, mesh, axis))


@lru_cache(maxsize=32)
def _jitted_sharded_scan(mesh, axis, n_iters, var_floor, lattice, model_treedef):
    """Cached jitted shard_map N-iteration EM scan (one trace per
    mesh/config, same policy as parallel/sequence.py)."""
    from jax.sharding import PartitionSpec as P

    model_spec = jax.tree.unflatten(
        model_treedef, [P()] * model_treedef.num_leaves
    )

    def shard_fn(model, batch):
        return _scan_em(
            model, batch, n_iters, var_floor, None, None, lattice, axis=axis
        )

    batch_spec = UtteranceBatch(features=P(axis, None, None), lengths=P(axis))
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(model_spec, batch_spec),
        out_specs=(model_spec, P(), P()),
        # pallas_call outputs carry no varying-mesh-axes annotation; the
        # psum inside the scan body establishes replication by construction
        check_vma=False,
    )
    return jax.jit(fn)


def em_train_scan_time_sharded(
    model: GmmHmm,
    batch,
    n_iters: int,
    mesh,
    axis: str = "time",
    var_floor: float = 0.0,
):
    """N SEQUENCE-PARALLEL EM iterations as ONE jitted shard_map(lax.scan)
    for the TIME-sharded E-step (parallel/sequence.py): each device runs
    its time shard's block-operator lattices + boundary exchanges per
    iteration, statistics psum over `axis` inside the scan body, and the
    replicated M-step is the scan carry (train_fast(time_mesh=...) drives
    it through the chunked convergence driver).

    batch: UtteranceBatch or tuple of per-stream batches;
    batch.max_frames must divide by the mesh's time axis.  Returns
    (final model, (n_iters,) log-prob history, (n_iters,) num_valid).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    batches = batch if isinstance(batch, tuple) else (batch,)
    lengths = batches[0].lengths
    feats = tuple(b.features for b in batches)
    n_dev = mesh.shape[axis]
    T = feats[0].shape[1]
    if T % n_dev:
        raise ValueError(
            f"time axis {T} not divisible by mesh axis '{axis}' ({n_dev}); "
            "pack the batch padded to a multiple"
        )
    model = _with_log_det(model)
    feats = tuple(
        jax.device_put(f, NamedSharding(mesh, P(None, axis, None)))
        for f in feats
    )
    fn = _jitted_time_sharded_scan(
        mesh, axis, n_iters, var_floor, jax.tree.structure(model), len(feats)
    )
    return fn(model, feats, lengths)


@lru_cache(maxsize=32)
def _jitted_time_sharded_scan(
    mesh, axis, n_iters, var_floor, model_treedef, n_streams
):
    """Cached jitted shard_map N-iteration sequence-parallel EM scan (one
    trace per mesh/config, same policy as _jitted_sharded_scan)."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.sequence import _e_step_shard

    n_dev = mesh.shape[axis]
    model_spec = jax.tree.unflatten(
        model_treedef, [P()] * model_treedef.num_leaves
    )

    def shard_fn(model, feats_loc, lengths):
        def step(m, _):
            st = _e_step_shard(
                m, feats_loc, lengths, n_dev=n_dev, axis=axis
            )  # stats already psum-reduced over `axis`
            new = m_step(m, st, var_floor=var_floor)
            return new, (st.log_prob, st.num_valid)

        final, (lps, nvs) = jax.lax.scan(step, model, None, length=n_iters)
        return final, lps, nvs

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            model_spec,
            (P(None, axis, None),) * n_streams,
            P(),
        ),
        out_specs=(model_spec, P(), P()),
        # the psums inside _e_step_shard establish replication of the
        # stats (and hence the M-step carry) by construction
        check_vma=False,
    )
    return jax.jit(fn)


def train_fast(
    model: GmmHmm,
    batch: UtteranceBatch,
    threshold: float = 1.0e-3,
    max_iterations: int = 100,
    var_floor: float = 0.0,
    time_mesh=None,
    data_mesh=None,
    chunk: int = 8,
    log_prob_offset: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """EM driver with the reference's convergence rule
    (|old - new| / |old| <= threshold, old initialized to 1.0, final pass
    not applying an update — T1:306-346).

    Iterations execute in device-side em_train_scan chunks, speculatively
    pipelined by the chunked convergence driver (train/driver.py) — the
    trajectory is bit-identical to the per-iteration loop, but the host
    round trip is paid once per `chunk` iterations instead of per
    iteration.

    time_mesh: optional ("time",) Mesh — run sequence-parallel
    (em_train_scan_time_sharded).
    data_mesh: optional Mesh with a "data" axis — run data-parallel via
    em_train_scan_sharded (the batch must divide the axis)."""
    from .driver import chunked_convergence_train
    from .em_parity import TrainResult

    if data_mesh is not None:
        run = lambda m, k: em_train_scan_sharded(
            m, batch, k, data_mesh, var_floor=var_floor
        )
    elif time_mesh is not None:
        run = lambda m, k: em_train_scan_time_sharded(
            m, batch, k, time_mesh, var_floor=var_floor
        )
    else:
        run = lambda m, k: em_train_scan(
            m, batch, k, var_floor=var_floor, abs_floors=abs_floors,
            zero_det_thresholds=zero_det_thresholds,
        )
    model, iteration, history, n_valid = chunked_convergence_train(
        model, run, threshold=threshold, max_iterations=max_iterations,
        chunk=chunk, log_prob_offset=log_prob_offset,
    )
    return TrainResult(
        model=model,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )
