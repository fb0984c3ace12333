"""GMM emission likelihoods.

Two paths:

* **log path** (fast path): log-space Gaussian mixture log-likelihoods.
  For diagonal covariance the per-frame/state/mixture log-pdf is expressed as
  one matmul over a lifted feature map [x, x^2], run at the float32
  precision policy of ops/backend.py (the lift cancels badly in TF32):

      log N(x; mu, s^2) = -1/2 (D log 2pi + sum log s^2)
                          - 1/2 sum x^2 k + sum x (mu k) - 1/2 sum mu^2 k
      with k = 1/s^2 (the stored inverse covariance).

  The x-dependent part is  [x, x^2] @ W  with W = [[mu*k], [-k/2]] stacked
  over (S*M), i.e. a (T, 2D) x (2D, S*M) GEMM.  Full covariance uses a
  quadratic-form einsum (D is small; XLA runs it as batched GEMMs).

* **parity path**: replicates the reference's probability-domain computation
  bit-comparably in float64 — `calc_gaus` (full: hmm-full-fs/
  hmm_continuous_full_fs.c:1834-1887 with the isinf->1e20 clamp at 1880-1883;
  diag: hmm-fs/hmm_continuous_fs.c:1804-1841, no clamp) and
  `calc_symbol_probab` (T1:1775-1813) including the in-place per-mixture
  posterior normalization the trainer relies on.

  Divergence from the reference (documented, not replicated): when det == 0
  the C function returns an *uninitialized* double (T1:1855,1886); we return
  0.0, the only defensible reading.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..models.gmm_hmm import DIAG, FULL, GAUS_INF_CLAMP, GmmStream
from .backend import PRECISION

# ---------------------------------------------------------------------------
# log path (fast path)
# ---------------------------------------------------------------------------


def log_gauss(frames: jax.Array, stream: GmmStream) -> jax.Array:
    """Per-mixture Gaussian log-pdfs.

    frames: (T, D); stream arrays shaped (S, M, ...). Returns (T, S, M).
    Uses the stored inverse covariance and original-covariance determinant
    (log |Sigma| = log |det|), matching the on-disk contract.
    """
    dtype = frames.dtype
    mu = stream.means.astype(dtype)  # (S, M, D)
    k = stream.inv_cov.astype(dtype)
    D = frames.shape[-1]
    # log|det| comes from the log-space representation (raw dets overflow f32).
    # det == 0 (log_det == -inf) marks a degenerate mixture: its likelihood is
    # 0 (log -inf), mirroring the parity path's det != 0 guard.
    lad = stream.log_abs_det()
    log_norm = (-0.5 * (D * math.log(2.0 * math.pi) + lad)).astype(dtype)
    degenerate = ~jnp.isfinite(log_norm)
    log_norm = jnp.where(degenerate, 0.0, log_norm)

    if stream.cov_type == DIAG:
        S, M = mu.shape[0], mu.shape[1]
        # Lifted-feature GEMM: (T, 2D) @ (2D, S*M)
        w_lin = (mu * k).reshape(S * M, D).T  # (D, SM)
        w_quad = (-0.5 * k).reshape(S * M, D).T  # (D, SM)
        w = jnp.concatenate([w_lin, w_quad], axis=0)  # (2D, SM)
        bias = -0.5 * jnp.sum(mu * mu * k, axis=-1).reshape(S * M)  # (SM,)
        feats = jnp.concatenate([frames, frames * frames], axis=-1)  # (T, 2D)
        q = jnp.dot(
            feats, w, preferred_element_type=dtype, precision=PRECISION
        ) + bias
        out = q.reshape(frames.shape[0], S, M) + log_norm
        return jnp.where(degenerate, -jnp.inf, out)
    elif stream.cov_type == FULL:
        dif = frames[:, None, None, :] - mu  # (T, S, M, D)
        quad = jnp.einsum(
            "tsmd,smde,tsme->tsm", dif, k, dif, preferred_element_type=dtype,
            precision=PRECISION,
        )
        out = -0.5 * quad + log_norm
        # The reference clamps overflowing full-cov densities to 1e20
        # (T1:1880-1883).  The log path clamps at log(1e20) directly: this is
        # the same protection, and it also catches the indefinite-covariance
        # explosions (negative quadratic forms from degenerate clusters) that
        # the C only catches once they overflow a double.
        out = jnp.minimum(out, math.log(GAUS_INF_CLAMP))
        return jnp.where(degenerate, -jnp.inf, out)
    raise ValueError(f"unknown cov_type {stream.cov_type}")


def log_state_emission(
    frames, streams: tuple[GmmStream, ...]
) -> jax.Array:
    """log b_i(o_t): per-state emission log-likelihood, product over streams.

    Equivalent (in log space) to the product over parameters in `calc_alpha`
    (T1:1437-1441).  Returns (T, S).

    frames: (T, D) shared across streams, or a tuple of per-stream (T, D_p)
    arrays — the reference reads one feature file per stream (R2:331-339),
    so multi-stream decode/scoring passes per-stream frames here.
    """
    per_stream = (
        tuple(frames)
        if isinstance(frames, (tuple, list))
        else (frames,) * len(streams)
    )
    if len(per_stream) != len(streams):
        raise ValueError(
            f"{len(streams)} streams need {len(streams)} frame sets, "
            f"got {len(per_stream)}"
        )
    total = None
    for frames, stream in zip(per_stream, streams):
        lg = log_gauss(frames, stream)  # (T, S, M)
        logw = jnp.log(stream.weights.astype(frames.dtype))
        per_state = jax.nn.logsumexp(lg + logw[None], axis=-1)  # (T, S)
        total = per_state if total is None else total + per_state
    return total


def log_mixture_posteriors(frames: jax.Array, stream: GmmStream):
    """(log b per state, per-mixture posterior) — the quantities the trainer's
    `calc_symbol_probab` produces (T1:1791-1811): posteriors are the weighted
    mixture likelihoods normalized within each state.

    Returns (log_b: (T, S), post: (T, S, M)) with post in linear domain.
    """
    lg = log_gauss(frames, stream) + jnp.log(stream.weights.astype(frames.dtype))[None]
    log_b = jax.nn.logsumexp(lg, axis=-1)
    post = jnp.exp(lg - log_b[..., None])
    # state with zero total likelihood -> zero posteriors (T1:1805-1811)
    post = jnp.where(jnp.isfinite(log_b)[..., None], post, 0.0)
    return log_b, post


# ---------------------------------------------------------------------------
# parity path (float64 probability domain, reference-exact semantics)
# ---------------------------------------------------------------------------


def prob_gauss_parity(frames: jax.Array, stream: GmmStream) -> jax.Array:
    """calc_gaus over all frames/states/mixtures in probability domain.

    frames (T, D) -> (T, S, M) float64.  Full covariance applies the
    isinf -> 1e20 clamp (T1:1880-1883); the diagonal variant has no clamp
    (T2:1804-1841).  det == 0 yields 0.0 (see module docstring).
    """
    frames = frames.astype(jnp.float64)
    mu = stream.means.astype(jnp.float64)
    k = stream.inv_cov.astype(jnp.float64)
    det = stream.det.astype(jnp.float64)
    D = frames.shape[-1]
    norm = (2.0 * math.pi) ** (D / 2.0)  # aux1 (T1:1851-1853)

    dif = frames[:, None, None, :] - mu  # (T, S, M, D)
    if stream.cov_type == FULL:
        quad = jnp.einsum(
            "tsmd,smde,tsme->tsm", dif, k, dif, precision=PRECISION
        )
    else:
        quad = jnp.einsum("tsmd,smd->tsm", dif * dif, k, precision=PRECISION)
    gaus = jnp.exp(-0.5 * quad) / (norm * jnp.sqrt(jnp.abs(det)))
    if stream.cov_type == FULL:
        gaus = jnp.where(jnp.isinf(gaus), GAUS_INF_CLAMP, gaus)
    return jnp.where(det != 0.0, gaus, 0.0)


def prob_state_emission_parity(frames: jax.Array, stream: GmmStream):
    """calc_symbol_probab for one stream: (symbol_probab (T, S),
    normalized per-mixture posteriors (T, S, M))."""
    gaus = prob_gauss_parity(frames, stream) * stream.weights.astype(jnp.float64)
    b = jnp.sum(gaus, axis=-1)  # (T, S)
    post = jnp.where(b[..., None] != 0.0, gaus / jnp.where(b[..., None] != 0.0, b[..., None], 1.0), 0.0)
    return b, post


def prob_emission_parity(
    frames_per_stream: list[jax.Array], streams: tuple[GmmStream, ...]
) -> jax.Array:
    """Product over streams of per-state symbol probabilities (T, S), as the
    forward pass consumes them (T1:1437-1441)."""
    total = None
    for frames, stream in zip(frames_per_stream, streams):
        b, _ = prob_state_emission_parity(frames, stream)
        total = b if total is None else total * b
    return total
