"""Log-domain forward/backward lattices as Pallas kernels on the Triton route.

On the GPU, XLA runs the lattice `lax.scan` (ops/forward_backward.py) as a
loop that launches a few small kernels per frame; each frame carries only
(S, B) floats, so the scan is bound by launch latency, not by the card.
These kernels run the whole recursion inside one launch: one program per
block of lanes (utterances, or utterance x word pairs), the (S, lanes)
log-alpha (or log-beta) carry in registers, and an in-kernel loop over
frames that loads one (S, lanes) emission tile per frame.

Layout: emissions (T, S, N) with lanes last; transitions either one shared
(S, S) matrix or one per lane, (S, S, N).  The state axis is padded to a
power of two with unreachable -inf states (Triton tiles are powers of two),
and the lane axis to the block with zero-length lanes.  For the small S of
word and phone HMMs the (from, to) contraction is a dense broadcast over
the padded (S, S, lanes) tile: a banded transition matrix simply has -inf
off its band, which drops out of the logsumexp exactly.

Length masking matches the XLA scans: forward rows at t >= length repeat
the last valid row; backward rows at t >= length - 1 hold the final-state
initialization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .backend import check_kernel_runnable

_NEG_INF = float("-inf")
# 32 lanes per program and 2 warps: the fastest of the block sizes swept on
# an H100 at S=8, B=2048, T=512 (PERF.md); 64 programs in flight there
_BLOCK_LANES = 32
_NUM_WARPS = 2


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _logsumexp(cand, axis):
    m = jnp.max(cand, axis=axis)
    m_safe = jnp.where(m == _NEG_INF, 0.0, m)
    s = jnp.sum(jnp.exp(cand - jnp.expand_dims(m_safe, axis)), axis=axis)
    return m_safe + jnp.log(s)


def _forward_kernel(lb_ref, lt_ref, len_ref, out_ref, *, n_frames, store_all):
    lengths = len_ref[...]  # (BL,)
    lt = lt_ref[...]  # (S_from, S_to, BL)
    s_pad = lt.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (s_pad, lengths.shape[0]), 0)
    a0 = lb_ref[0] + jnp.where(row == 0, 0.0, _NEG_INF)
    if store_all:
        out_ref[0] = a0

    def body(t, a):
        new = _logsumexp(a[:, None, :] + lt, axis=0) + lb_ref[t]
        new = jnp.where(t < lengths[None, :], new, a)
        if store_all:
            out_ref[t] = new
        return new

    a = jax.lax.fori_loop(1, n_frames, body, a0)
    if not store_all:
        out_ref[...] = a


def _backward_kernel(lb_ref, lt_ref, len_ref, out_ref, *, n_frames, final_state):
    lengths = len_ref[...]
    lt = lt_ref[...]
    s_pad = lt.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (s_pad, lengths.shape[0]), 0)
    init = jnp.where(row == final_state, 0.0, _NEG_INF)
    last = lengths - 1
    out_ref[n_frames - 1] = init

    def body(k, b):
        t = n_frames - 2 - k
        nxt = lb_ref[t + 1] + b  # (S_to, BL)
        new = _logsumexp(lt + nxt[None, :, :], axis=1)
        new = jnp.where(t < last[None, :], new, init)
        out_ref[t] = new
        return new

    jax.lax.fori_loop(0, n_frames - 1, body, init)


def _prepare(log_b, log_trans, lengths, block_lanes):
    """Pad states to a power of two and lanes to the block; returns the
    padded arrays, the transition block spec and the original sizes."""
    T, S, N = log_b.shape
    s_pad = max(_next_pow2(S), 2)
    n_pad = -(-N // block_lanes) * block_lanes
    dtype = log_b.dtype
    log_b = jnp.pad(
        log_b, ((0, 0), (0, s_pad - S), (0, n_pad - N)), constant_values=_NEG_INF
    )
    lengths = jnp.pad(lengths.astype(jnp.int32), (0, n_pad - N))
    log_trans = log_trans.astype(dtype)
    if log_trans.ndim == 2:
        lt = jnp.pad(
            log_trans, ((0, s_pad - S), (0, s_pad - S)), constant_values=_NEG_INF
        )
        lt = jnp.broadcast_to(lt[:, :, None], (s_pad, s_pad, block_lanes))
        lt_spec = pl.BlockSpec((s_pad, s_pad, block_lanes), lambda i: (0, 0, 0))
    else:
        lt = jnp.pad(
            log_trans,
            ((0, s_pad - S), (0, s_pad - S), (0, n_pad - N)),
            constant_values=_NEG_INF,
        )
        lt_spec = pl.BlockSpec((s_pad, s_pad, block_lanes), lambda i: (0, 0, i))
    return log_b, lt, lengths, lt_spec, (T, S, N, s_pad, n_pad)


@functools.partial(
    jax.jit, static_argnames=("final_only", "block_lanes", "interpret")
)
def forward_lattice(
    log_b: jax.Array,
    log_trans: jax.Array,
    lengths: jax.Array,
    final_only: bool = False,
    block_lanes: int = _BLOCK_LANES,
    interpret: bool = False,
) -> jax.Array:
    """Log-alpha over lanes.  log_b (T, S, N); log_trans (S, S) or
    (S, S, N); lengths (N,).  Returns the (T, S, N) lattice, or with
    final_only the (S, N) last valid row (what scoring needs)."""
    check_kernel_runnable(interpret)
    lb, lt, ln, lt_spec, (T, S, N, s_pad, n_pad) = _prepare(
        log_b, log_trans, lengths, block_lanes
    )
    if final_only:
        out_shape = jax.ShapeDtypeStruct((s_pad, n_pad), lb.dtype)
        out_spec = pl.BlockSpec((s_pad, block_lanes), lambda i: (0, i))
    else:
        out_shape = jax.ShapeDtypeStruct((T, s_pad, n_pad), lb.dtype)
        out_spec = pl.BlockSpec((T, s_pad, block_lanes), lambda i: (0, 0, i))
    out = pl.pallas_call(
        functools.partial(_forward_kernel, n_frames=T, store_all=not final_only),
        out_shape=out_shape,
        grid=(n_pad // block_lanes,),
        in_specs=[
            # T sits in the block only as the range of the per-frame loads
            pl.BlockSpec((T, s_pad, block_lanes), lambda i: (0, 0, i)),
            lt_spec,
            pl.BlockSpec((block_lanes,), lambda i: (i,)),
        ],
        out_specs=out_spec,
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="lattice_forward",
    )(lb, lt, ln)
    return out[:S, :N] if final_only else out[:, :S, :N]


@functools.partial(jax.jit, static_argnames=("block_lanes", "interpret"))
def backward_lattice(
    log_b: jax.Array,
    log_trans: jax.Array,
    lengths: jax.Array,
    block_lanes: int = _BLOCK_LANES,
    interpret: bool = False,
) -> jax.Array:
    """Log-beta over lanes, final-state initialization (the reference's
    beta[S-1][T-1] = 1).  Same layout as forward_lattice; returns (T, S, N)."""
    check_kernel_runnable(interpret)
    lb, lt, ln, lt_spec, (T, S, N, s_pad, n_pad) = _prepare(
        log_b, log_trans, lengths, block_lanes
    )
    out = pl.pallas_call(
        functools.partial(_backward_kernel, n_frames=T, final_state=S - 1),
        out_shape=jax.ShapeDtypeStruct((T, s_pad, n_pad), lb.dtype),
        grid=(n_pad // block_lanes,),
        in_specs=[
            pl.BlockSpec((T, s_pad, block_lanes), lambda i: (0, 0, i)),
            lt_spec,
            pl.BlockSpec((block_lanes,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((T, s_pad, block_lanes), lambda i: (0, 0, i)),
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="lattice_backward",
    )(lb, lt, ln)
    return out[:, :S, :N]
