"""Sequence (time) parallelism: forward/backward over a time-sharded lattice.

The reference caps utterances at MAX_TIME frames in fixed single-core arrays
(hmm-full-fs/hmm_continuous_full_fs.c:43) — its only "long sequence" device is
the per-frame scaling factor.  This design (SURVEY §2.4 SP row, §5
long-context plan) instead splits the **time axis across devices**:

The forward recursion is a chain of per-frame (S, S) operators under the
(logsumexp, +) semiring:

    alpha_t = alpha_{t-1} ∘ M_t,   M_t[i, j] = log_trans[i, j] + log_b[t, j]

so a block of frames composes into one block operator, and blocks on
different devices can be reduced independently.  Each device:

  1. reduces its local frame block to one (S, S) block operator — a local
     `lax.scan` of log-matmuls (the O(T/D · S^3) price of the associative
     formulation, amortized across devices);
  2. joins block operators across devices with a Hillis-Steele **exclusive
     prefix scan**: ceil(log2(D)) rounds of `jax.lax.ppermute`,
     exchanging one (S, S) boundary operator per round — this is the
     "boundary state exchange" of the SP design;
  3. replays its own block from the incoming boundary state at O(S^2)/frame
     to emit its slice of the (T, S) log-alpha lattice.

Padded frames (t >= length) contribute identity operators, so the lattice
semantics match ops/forward_backward.py exactly: forward rows past the end
repeat the last valid row; backward rows hold the final-state initialization.
Everything here is shape-static and jit-compiled via `shard_map`; XLA
emits the collectives (NCCL on GPUs).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.backend import PRECISION

shard_map = jax.shard_map


def _pvary(x, axis):
    """Promote a replicated constant to varying over `axis` (shard_map VMA)."""
    return lax.pcast(x, axis, to="varying")

TIME_AXIS = "time"


def make_time_mesh(n_time: int | None = None, devices=None) -> Mesh:
    """A 1-D ("time",) mesh over the available devices."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    if n_time is None:
        n_time = len(devices)
    return Mesh(np.asarray(devices[:n_time]), (TIME_AXIS,))


def pad_time(log_b: jax.Array, multiple: int) -> jax.Array:
    """Pad the time axis to a multiple (padded rows are masked by `length`)."""
    T = log_b.shape[0]
    pad = (-T) % multiple
    if pad == 0:
        return log_b
    return jnp.pad(log_b, ((0, pad), (0, 0)))


def _log_matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """(S, S) @ (S, S) under the (logsumexp, +) semiring."""
    return jax.nn.logsumexp(a[:, :, None] + b[None, :, :], axis=1)


def _eye_log(S: int, dtype) -> jax.Array:
    return jnp.where(jnp.eye(S, dtype=bool), 0.0, -jnp.inf).astype(dtype)


def _frame_ops(lb, log_trans, t_global, length, first_frame_diag, axis):
    """Per-frame transfer operators for a local block.

    M_t = log_trans + log_b[t] broadcast over rows; global frame 0 is the
    initialization frame (pi = one-hot state 0, T1:218-219), whose operator
    is diag(log_b[0]) so that alpha_0 = init + log_b[0]; frames at
    t >= length are identity (padding carries the state through unchanged).
    """
    Tl, S = lb.shape
    dtype = lb.dtype
    eye_b = jnp.eye(S, dtype=bool)
    mats = log_trans[None, :, :] + lb[:, None, :]  # (Tl, S, S)
    if first_frame_diag:
        diag0 = jnp.where(eye_b[None], lb[:, None, :], -jnp.inf).astype(dtype)
        mats = jnp.where((t_global == 0)[:, None, None], diag0, mats)
    eye_l = _pvary(_eye_log(S, dtype), axis)
    mats = jnp.where((t_global < length)[:, None, None], mats, eye_l[None])
    return mats


def _block_reduce(mats, axis):
    """Compose a block of per-frame operators left-to-right: M_a @ ... @ M_z."""
    S = mats.shape[-1]

    def step(carry, m):
        return _log_matmul(carry, m), None

    out, _ = lax.scan(step, _pvary(_eye_log(S, mats.dtype), axis), mats)
    return out


def _exclusive_prefix(block, idx, n_dev: int, axis: str):
    """Exclusive left-prefix product of per-device block operators:
    E_k = B_0 @ ... @ B_{k-1} (identity on device 0).  Hillis-Steele over
    `ppermute`; non-receiving devices get zeros from ppermute, masked via
    the device index."""
    S = block.shape[-1]
    x = block
    shift = 1
    while shift < n_dev:
        received = lax.ppermute(
            x, axis, perm=[(k, k + shift) for k in range(n_dev - shift)]
        )
        x = jnp.where(idx >= shift, _log_matmul(received, x), x)
        shift *= 2
    excl = lax.ppermute(x, axis, perm=[(k, k + 1) for k in range(n_dev - 1)])
    return jnp.where(idx == 0, _pvary(_eye_log(S, block.dtype), axis), excl)


def _exclusive_suffix(block, idx, n_dev: int, axis: str):
    """Exclusive right-suffix product: E_k = B_{k+1} @ ... @ B_{D-1}
    (identity on the last device)."""
    S = block.shape[-1]
    x = block
    shift = 1
    while shift < n_dev:
        received = lax.ppermute(
            x, axis, perm=[(k, k - shift) for k in range(shift, n_dev)]
        )
        x = jnp.where(idx < n_dev - shift, _log_matmul(x, received), x)
        shift *= 2
    excl = lax.ppermute(x, axis, perm=[(k, k - 1) for k in range(1, n_dev)])
    return jnp.where(
        idx == n_dev - 1, _pvary(_eye_log(S, block.dtype), axis), excl
    )


def _forward_shard(lb, log_trans, length, *, n_dev: int, axis: str):
    Tl, S = lb.shape
    idx = lax.axis_index(axis)
    t_global = idx * Tl + jnp.arange(Tl)
    mats = _frame_ops(lb, log_trans, t_global, length, True, axis)

    block = _block_reduce(mats, axis)  # (S, S): M_{t0} @ ... @ M_{t0+Tl-1}
    prefix = _exclusive_prefix(block, idx, n_dev, axis)
    # alpha entering this block: init one-hot(0) pushed through the prefix
    alpha_in = prefix[0, :]  # (S,)

    def step(carry, m):
        new = jax.nn.logsumexp(carry[:, None] + m, axis=0)
        return new, new

    _, rows = lax.scan(step, alpha_in, mats)
    return rows  # (Tl, S)


def _backward_shard(lb, log_trans, length, *, n_dev: int, axis: str):
    Tl, S = lb.shape
    idx = lax.axis_index(axis)
    t_global = idx * Tl + jnp.arange(Tl)
    # backward never applies the init-frame operator (beta_{-1} is not a
    # thing), so no first-frame special case
    mats = _frame_ops(lb, log_trans, t_global, length, False, axis)

    block = _block_reduce(mats, axis)
    suffix = _exclusive_suffix(block, idx, n_dev, axis)
    # beta at this block's LAST row: remaining blocks applied to the
    # final-state one-hot (reference init beta[S-1][T-1] = 1, T1:1511-1513)
    beta_last = suffix[:, S - 1]  # (S,)

    def step(carry, m):
        new = jax.nn.logsumexp(m + carry[None, :], axis=1)
        return new, new

    # rows 0..Tl-2 use operators M_{t+1} (local indices 1..Tl-1)
    _, rows = lax.scan(step, beta_last, mats[1:], reverse=True)
    return jnp.concatenate([rows, beta_last[None]], axis=0)  # (Tl, S)


@lru_cache(maxsize=64)
def _jitted_lattice(kernel, mesh: Mesh, axis: str):
    """Cached jitted shard_map lattice callable, keyed on (kernel, mesh,
    axis).  Building a fresh shard_map + jax.jit per call would retrace —
    and recompile — every invocation (round-1 weakness: train_fast over a
    time mesh paid a full compile per EM iteration)."""
    n_dev = mesh.shape[axis]
    fn = shard_map(
        partial(kernel, n_dev=n_dev, axis=axis),
        mesh=mesh,
        in_specs=(P(axis, None), P(), P()),
        out_specs=P(axis, None),
    )
    return jax.jit(fn)


def _sharded_lattice(kernel, log_b, log_trans, length, mesh, axis):
    n_dev = mesh.shape[axis]
    T, S = log_b.shape
    if T % n_dev:
        raise ValueError(
            f"time axis {T} not divisible by mesh axis '{axis}' ({n_dev}); "
            "use pad_time and pass the true length"
        )
    length = jnp.asarray(T if length is None else length, jnp.int32)
    log_b = jax.device_put(log_b, NamedSharding(mesh, P(axis, None)))
    return _jitted_lattice(kernel, mesh, axis)(log_b, log_trans, length)


def log_forward_time_sharded(
    log_b: jax.Array,
    log_trans: jax.Array,
    mesh: Mesh,
    length: jax.Array | int | None = None,
    axis: str = TIME_AXIS,
) -> jax.Array:
    """(T, S) log-alpha lattice with T sharded over `axis` of `mesh`.

    Semantics identical to ops.forward_backward.log_forward_full (rows at
    t >= length repeat the last valid row); scores read off the final row
    as usual (score_total / score_final_state).
    """
    return _sharded_lattice(_forward_shard, log_b, log_trans, length, mesh, axis)


def log_backward_time_sharded(
    log_b: jax.Array,
    log_trans: jax.Array,
    mesh: Mesh,
    length: jax.Array | int | None = None,
    axis: str = TIME_AXIS,
) -> jax.Array:
    """(T, S) log-beta lattice (final-state initialization), T sharded over
    `axis`.  Matches ops.forward_backward.log_backward_full."""
    return _sharded_lattice(_backward_shard, log_b, log_trans, length, mesh, axis)


# ---------------------------------------------------------------------------
# sequence-parallel EM E-step
# ---------------------------------------------------------------------------


def _e_step_shard(model, feats_loc, lengths, *, n_dev: int, axis: str):
    """Full Baum-Welch sufficient statistics from one time shard.

    feats_loc: tuple of per-stream (B, Tl, D_p) local frame blocks; lengths:
    (B,) true (global) frame counts.  Emission, gamma, and the per-frame xi
    terms are local to the shard; the lattices use the block-operator prefix
    scan above; the only extra cross-chip traffic is ONE (B, S) `ppermute`
    carrying (log_b + log_beta) at each shard's first frame to its left
    neighbour — the boundary term of xi_t = alpha_t + trans + b_{t+1} +
    beta_{t+1} − Z for the shard-crossing transition.  Statistics are then
    `psum`-reduced over the time axis (they are sums over frames, so time
    sharding commutes with the reduction exactly as data sharding does for
    the batch axis — SURVEY §2.4 SP row).
    """
    from ..train.em import StreamStats, SuffStats

    B, Tl = feats_loc[0].shape[:2]
    S = model.num_states
    dtype = feats_loc[0].dtype
    log_trans = model.log_trans().astype(dtype)
    idx = lax.axis_index(axis)
    t_global = idx * Tl + jnp.arange(Tl)  # (Tl,) varying

    log_b = None
    posts = []
    from ..ops.emission import log_mixture_posteriors

    for stream, sf in zip(model.streams, feats_loc):
        D = sf.shape[-1]
        lb_s, post_s = log_mixture_posteriors(sf.reshape(B * Tl, D), stream)
        posts.append(post_s.reshape(B, Tl, S, -1))
        lb_s = lb_s.reshape(B, Tl, S)
        log_b = lb_s if log_b is None else log_b + lb_s

    la = jax.vmap(
        lambda lb, l: _forward_shard(lb, log_trans, l, n_dev=n_dev, axis=axis)
    )(log_b, lengths)  # (B, Tl, S)
    lbw = jax.vmap(
        lambda lb, l: _backward_shard(lb, log_trans, l, n_dev=n_dev, axis=axis)
    )(log_b, lengths)  # (B, Tl, S)

    # final-state log Z lives on the last shard (padded rows repeat the last
    # valid forward row); broadcast it with a psum
    z_local = jnp.where(idx == n_dev - 1, la[:, -1, S - 1], 0.0)
    log_z = lax.psum(z_local, axis)  # (B,) replicated
    valid = jnp.isfinite(log_z) & (lengths > 0)
    safe_z = jnp.where(valid, log_z, 0.0)
    vmask = valid.astype(dtype)

    frame_mask = (t_global[None, :] < lengths[:, None]).astype(dtype)  # (B, Tl)
    gamma = (
        jnp.exp(jnp.minimum(la + lbw - safe_z[:, None, None], 0.0))
        * frame_mask[..., None]
        * vmask[:, None, None]
    )  # (B, Tl, S)

    # xi boundary exchange: shard k needs (log_b + beta) at global frame
    # t0 + Tl, i.e. the NEXT shard's first row
    fwd_in = log_b + lbw  # (B, Tl, S)
    nxt = lax.ppermute(
        fwd_in[:, 0], axis, perm=[(k + 1, k) for k in range(n_dev - 1)]
    )  # (B, S); zeros on the last shard (its final frame has no xi anyway)
    fwd_in_next = jnp.concatenate([fwd_in[:, 1:], nxt[:, None]], axis=1)

    xi_mask = (
        (t_global[None, :] < lengths[:, None] - 1).astype(dtype)
        * vmask[:, None]
    )  # (B, Tl)
    log_xi = (
        la[:, :, :, None]
        + log_trans[None, None]
        + fwd_in_next[:, :, None, :]
        - safe_z[:, None, None, None]
    )  # (B, Tl, from, to)
    xi = jnp.exp(jnp.minimum(log_xi, 0.0)) * xi_mask[..., None, None]
    num_trans = lax.psum(xi.sum((0, 1)), axis)  # (S, S)
    den_trans = lax.psum((gamma * xi_mask[..., None]).sum((0, 1)), axis)
    den_mix = lax.psum(gamma.sum((0, 1)), axis)

    stream_stats = []
    for stream, post, sf in zip(model.streams, posts, feats_loc):
        from ..models.gmm_hmm import FULL

        gm = gamma[..., None] * post  # (B, Tl, S, M)
        w = lax.psum(gm.sum((0, 1)), axis)
        x = lax.psum(
            jnp.einsum(
                "btsm,btd->smd", gm, sf, preferred_element_type=dtype,
                precision=PRECISION,
            ),
            axis,
        )
        if stream.cov_type == FULL:
            xx = lax.psum(
                jnp.einsum(
                    "btsm,btd,bte->smde", gm, sf, sf,
                    preferred_element_type=dtype, precision=PRECISION,
                ),
                axis,
            )
        else:
            xx = lax.psum(
                jnp.einsum(
                    "btsm,btd->smd", gm, sf * sf, preferred_element_type=dtype,
                    precision=PRECISION,
                ),
                axis,
            )
        stream_stats.append(StreamStats(w=w, x=x, xx=xx))

    return SuffStats(
        num_trans=num_trans,
        den_trans=den_trans,
        den_mix=den_mix,
        streams=tuple(stream_stats),
        log_prob=jnp.sum(jnp.where(valid, log_z, 0.0)),
        num_valid=vmask.sum(),
    )


def e_step_time_sharded(model, batch, mesh: Mesh, axis: str = TIME_AXIS):
    """Batched Baum-Welch E-step with the TIME axis sharded across chips.

    Statistics are bit-equivalent (to reduction-order rounding) to
    train.em.e_step; use when a single utterance's lattice does not fit one
    chip's HBM (the reference's only answer was a hard MAX_TIME cap,
    hmm-full-fs/hmm_continuous_full_fs.c:43).  Composes with data
    parallelism: lay the batch on a `data` mesh axis outside and this on a
    `time` axis.

    batch: UtteranceBatch (or tuple of per-stream batches with equal frame
    counts); `batch.max_frames` must divide evenly by the mesh's time axis —
    pack with pad_to a multiple (io.dataset.pack_utterances pads anyway).
    """
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
    feats = tuple(
        jax.device_put(f, NamedSharding(mesh, P(None, axis, None)))
        for f in feats
    )
    treedef = jax.tree.structure(model)
    return _jitted_e_step(mesh, axis, treedef)(model, feats, lengths)


@lru_cache(maxsize=64)
def _jitted_e_step(mesh: Mesh, axis: str, model_treedef):
    """Cached jitted shard_map E-step (see _jitted_lattice): one trace and
    one compile per (mesh, model structure, shape) — NOT one per call."""
    n_dev = mesh.shape[axis]
    model_spec = jax.tree.unflatten(
        model_treedef, [P()] * model_treedef.num_leaves
    )
    fn = shard_map(
        partial(_e_step_shard, n_dev=n_dev, axis=axis),
        mesh=mesh,
        in_specs=(model_spec, P(None, axis, None), P()),
        out_specs=P(),
    )
    return jax.jit(fn)
