"""Forward / backward recursions.

Two formulations:

* **log path** (fast path): log-space `lax.scan` recursions — no scaling
  factors, numerically unbounded sequence length, mask-aware for padded
  batches.  Score equivalences with the reference's scaled recursion
  (T1:1414-1473, R1/R2 `calc_probability`):

      total-probability score  (-sum log c_t)            == logsumexp_i log_alpha[T-1, i]
      final-state score (-sum log c_t + log a^[S-1][T-1]) == log_alpha[T-1, S-1]

  so both CLI scoring modes read directly off the final log-alpha row.

* **parity path**: the scaled probability-domain recursion exactly as the C
  does it, float64: per-frame normalization c_t = 1 / sum_i alpha_i
  (T1:1447-1468), backward initialized final-state-only with the same scaling
  factors and the isinf -> 1e200 clamp (T1:1511-1540).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.gmm_hmm import BETA_INF_CLAMP

# ---------------------------------------------------------------------------
# log path
# ---------------------------------------------------------------------------


def log_forward(
    log_b: jax.Array, log_trans: jax.Array, length: jax.Array | None = None
) -> jax.Array:
    """Log-space forward recursion.

    log_b: (T, S) per-state emission log-likelihoods, log_trans: (S, S).
    Initial state is state 0 (reference contract, T1:218-219).
    length: optional scalar number of valid frames (for padded inputs);
    steps t >= length carry log_alpha through unchanged, so the final carry
    equals log_alpha at the last valid frame.

    Returns log_alpha_final: (S,) — the last valid row of log-alpha.
    """
    S = log_b.shape[-1]
    init = jnp.full((S,), -jnp.inf, log_b.dtype).at[0].set(0.0) + log_b[0]

    def step(carry, inputs):
        lb, t = inputs
        new = jax.nn.logsumexp(carry[:, None] + log_trans, axis=0) + lb
        if length is not None:
            new = jnp.where(t < length, new, carry)
        return new, None

    T = log_b.shape[0]
    ts = jnp.arange(1, T)
    final, _ = jax.lax.scan(step, init, (log_b[1:], ts), unroll=8)
    return final


def log_forward_full(
    log_b: jax.Array, log_trans: jax.Array, length: jax.Array | None = None
) -> jax.Array:
    """Like log_forward but returns the whole (T, S) log-alpha lattice
    (needed by EM).  Rows at t >= length repeat the last valid row."""
    S = log_b.shape[-1]
    init = jnp.full((S,), -jnp.inf, log_b.dtype).at[0].set(0.0) + log_b[0]

    def step(carry, inputs):
        lb, t = inputs
        new = jax.nn.logsumexp(carry[:, None] + log_trans, axis=0) + lb
        if length is not None:
            new = jnp.where(t < length, new, carry)
        return new, new

    ts = jnp.arange(1, log_b.shape[0])
    _, rest = jax.lax.scan(step, init, (log_b[1:], ts), unroll=8)
    return jnp.concatenate([init[None], rest], axis=0)


def log_backward_full(
    log_b: jax.Array,
    log_trans: jax.Array,
    length: jax.Array | None = None,
    final_state_only: bool = True,
) -> jax.Array:
    """Log-space backward recursion, (T, S) log-beta lattice.

    final_state_only=True matches the reference's initialization
    beta[S-1][T-1] = 1, else 0 (T1:1511-1513) — the model must end in the
    final state.  With padding, the "last frame" is length-1: positions
    t >= length hold the initial condition and the recursion starts there.
    """
    T, S = log_b.shape
    beta_T = jnp.full((S,), -jnp.inf, log_b.dtype)
    beta_T = beta_T.at[S - 1].set(0.0) if final_state_only else jnp.zeros_like(beta_T)
    last = length - 1 if length is not None else T - 1

    def step(carry, inputs):
        lb_next, t = inputs  # lb_next = log_b[t+1], computing beta[t]
        new = jax.nn.logsumexp(log_trans + (lb_next + carry)[None, :], axis=1)
        if length is not None:
            # t >= last: stay at the initial condition until the recursion
            # "begins" at the last valid frame.
            new = jnp.where(t < last, new, beta_T)
        return new, new

    ts = jnp.arange(T - 1)
    _, betas = jax.lax.scan(
        step, beta_T, (log_b[1:], ts), reverse=True, unroll=8
    )
    return jnp.concatenate([betas, beta_T[None]], axis=0)


def score_total(log_alpha_final: jax.Array) -> jax.Array:
    """Total-probability score: R1's -sum log c_t (recognition-full-fs:822-836)."""
    return jax.nn.logsumexp(log_alpha_final, axis=-1)


def score_final_state(log_alpha_final: jax.Array) -> jax.Array:
    """Final-state score: trainer/R2's -sum log c_t + log a^[S-1][T-1]
    (T1:1564-1586, recognition-fs:820-836)."""
    return log_alpha_final[..., -1]


# ---------------------------------------------------------------------------
# parity path (scaled probability domain, float64)
# ---------------------------------------------------------------------------


def scaled_forward_parity(b: jax.Array, trans: jax.Array):
    """The reference's scaled forward recursion (T1:1414-1473), float64.

    b: (T, S) per-state symbol probabilities (product over streams),
    trans: (S, S).  Returns (alpha: (T, S) scaled, scaling_factor: (T,))
    with scaling_factor[t] = 1 / sum_i alpha_raw[t, i] exactly as stored by
    the C code.
    """
    b = b.astype(jnp.float64)
    trans = trans.astype(jnp.float64)
    S = b.shape[-1]
    pi = jnp.zeros((S,), jnp.float64).at[0].set(1.0)

    a0_raw = pi * b[0]
    c0 = 1.0 / jnp.sum(a0_raw)
    a0 = a0_raw * c0

    def step(carry, bt):
        a_raw = (carry @ trans) * bt
        c = 1.0 / jnp.sum(a_raw)
        a = a_raw * c
        return a, (a, c)

    _, (alphas, cs) = jax.lax.scan(step, a0, b[1:])
    alpha = jnp.concatenate([a0[None], alphas], axis=0)
    scaling = jnp.concatenate([c0[None], cs], axis=0)
    return alpha, scaling


def scaled_backward_parity(b: jax.Array, trans: jax.Array, scaling: jax.Array):
    """The reference's scaled backward recursion (T1:1493-1543), float64,
    final-state initialization and the isinf -> 1e200 clamp (T1:1540).

    Returns beta: (T, S) scaled with the forward scaling factors.
    """
    b = b.astype(jnp.float64)
    trans = trans.astype(jnp.float64)
    T, S = b.shape
    beta_T = jnp.zeros((S,), jnp.float64).at[S - 1].set(1.0) * scaling[T - 1]

    def step(carry, inputs):
        bt_next, c_t = inputs  # computing beta[t] from beta[t+1]
        new = trans @ (carry * bt_next)
        new = new * c_t
        new = jnp.where(jnp.isinf(new), BETA_INF_CLAMP, new)
        return new, new

    _, betas = jax.lax.scan(
        step, beta_T, (b[1:], scaling[:-1]), reverse=True
    )
    return jnp.concatenate([betas, beta_T[None]], axis=0)


def parity_score_total(scaling: jax.Array) -> jax.Array:
    """R1 calc_probability: -sum log c_t."""
    return -jnp.sum(jnp.log(scaling))


def parity_score_final_state(scaling: jax.Array, alpha: jax.Array) -> jax.Array:
    """T1/R2 calc_probability: -sum log c_t + log alpha_scaled[T-1, S-1]."""
    return -jnp.sum(jnp.log(scaling)) + jnp.log(alpha[-1, -1])


def log_forward_assoc(
    log_b: jax.Array, log_trans: jax.Array, length: jax.Array | None = None
) -> jax.Array:
    """Parallel-prefix (associative-scan) log-space forward.

    The sequential recursion has O(T) depth; for very long utterances the
    forward pass can instead be computed as a prefix product of per-frame
    transfer matrices M_t[i, j] = log_trans[i, j] + log_b[t, j] under the
    log-matmul semiring, which `lax.associative_scan` evaluates in O(log T)
    parallel depth (O(T S^3) work vs O(T S^2) — profitable when T is the
    bottleneck and S is small; SURVEY §5 long-context plan).

    Padded steps contribute identity matrices, so the result equals
    log_forward at each utterance's last valid frame.  Returns (S,) final
    log-alpha; scores read off as with log_forward.
    """
    T, S = log_b.shape
    mats = log_trans[None, :, :] + log_b[1:, None, :]  # (T-1, S, S)
    if length is not None:
        t_idx = jnp.arange(1, T)
        eye_log = jnp.where(
            jnp.eye(S, dtype=bool), 0.0, -jnp.inf
        ).astype(log_b.dtype)
        mats = jnp.where(
            (t_idx < length)[:, None, None], mats, eye_log[None]
        )

    def op(a, b):
        return jax.nn.logsumexp(a[..., :, :, None] + b[..., None, :, :], axis=-2)

    if T == 1:
        prod = None
    else:
        prod = jax.lax.associative_scan(op, mats, axis=0)[-1]  # (S, S)

    init = jnp.full((S,), -jnp.inf, log_b.dtype).at[0].set(0.0) + log_b[0]
    if prod is None:
        return init
    return jax.nn.logsumexp(init[:, None] + prod, axis=0)
