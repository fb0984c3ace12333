"""Tied-state (senone) embedded re-estimation.

The tied variant of train/embedded.py: each utterance gathers the senone
parameters for its L*S transcript positions (an utterance touches a tiny
slice of the inventory, so gather-then-compute beats materializing (T, N, M)
posteriors for all N senones), and the E-step statistics scatter-add into
senone space — tying IS the scatter.  Per-unit transition statistics stay
unit-level.

This is BASELINE.json config 5's compute/communication shape: with the
senone axis sharded over a `model` mesh axis and utterances over `data`,
the scatter-reductions become the mixture-sharded multi-host EM all-reduces.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.tying import TiedHmmSet
from ..ops.emission import log_mixture_posteriors
from ..ops.forward_backward import log_backward_full, log_forward_full
from .em import StreamStats, gmm_moment_stats, update_stream
from .embedded import (
    _composed_log_trans,
    _jitted_batch_stats_shard,
    shard_buckets,
)


def tied_utterance_stats_positional(
    tied: TiedHmmSet,
    transcript: jax.Array,
    feats: jax.Array,
    length: jax.Array,
):
    """Per-POSITION E-step statistics for one utterance against a tied set.

    Returns (StreamStats over the L*S transcript positions, den_mix_pos
    (L*S,), xi_pos (L, S, S), den_trans_pos (L, S), log_prob, valid).
    Scattering into senone/unit space happens OUTSIDE the per-utterance
    vmap (tied_batch_stats): scattering here would materialize a full
    (B, N, M, D...) inventory per batch — gigabytes at config-5 scale —
    where the positional stats are only (B, L*S, M, D...).
    """
    P = tied.num_units
    S = tied.num_states
    N = tied.num_senones
    L = transcript.shape[0]
    T = feats.shape[0]
    dtype = feats.dtype

    # gather the per-position senone parameters (L*S of them) and compute
    # emissions on the gathered bank: computing/materializing posteriors for
    # the FULL inventory (T x N x M) would blow HBM at config-5 scale
    # (N=2000, M=16) for no benefit — an utterance touches <= L*S senones.
    sen_ids = tied.state_map[transcript]  # (L, S)
    flat_ids = sen_ids.reshape(L * S)
    sen = tied.senones
    gathered = sen.replace(
        weights=sen.weights[flat_ids],
        means=sen.means[flat_ids],
        inv_cov=sen.inv_cov[flat_ids],
        det=sen.det[flat_ids],
        log_det=None if sen.log_det is None else sen.log_det[flat_ids],
    )
    pos_lb, pos_post = log_mixture_posteriors(feats, gathered)  # (T,LS),(T,LS,M)
    lb_pos = pos_lb.reshape(T, L, S)
    log_b = pos_lb

    unit_logt = tied.log_trans().astype(dtype)
    pos_logt = unit_logt[transcript]  # (L, S, S)
    log_trans = _composed_log_trans(pos_logt)

    la = log_forward_full(log_b, log_trans, length)
    lbw = log_backward_full(log_b, log_trans, length)
    log_z = la[-1, -1]
    valid = jnp.isfinite(log_z) & (length > 0)
    safe_z = jnp.where(valid, log_z, 0.0)

    t_idx = jnp.arange(T)
    frame_mask = (t_idx < length).astype(dtype)
    la_p = la.reshape(T, L, S)
    lb_p = lbw.reshape(T, L, S)
    gamma = jnp.exp(jnp.minimum(la_p + lb_p - safe_z, 0.0)) * frame_mask[:, None, None]

    xi_mask = (t_idx[:-1] < length - 1).astype(dtype)
    fwd_in = (lb_pos + lb_p)[1:]
    log_xi = la_p[:-1, :, :, None] + pos_logt[None] + fwd_in[:, :, None, :] - safe_z
    xi = jnp.exp(jnp.minimum(log_xi, 0.0)) * xi_mask[:, None, None, None]
    xi_pos = xi.sum(0)
    if L > 1:
        arc = pos_logt[:-1, S - 1, S - 1]
        cross = la_p[:-1, :-1, S - 1] + arc[None] + fwd_in[:, 1:, 0] - safe_z
        cross_flow = jnp.exp(jnp.minimum(cross, 0.0)) * xi_mask[:, None]
        xi_pos = xi_pos.at[:-1, S - 1, S - 1].add(cross_flow.sum(0))

    den_trans_pos = (gamma[:-1] * xi_mask[:, None, None]).sum(0)  # (L, S)

    # positional GMM statistics (scatter to the senone inventory happens at
    # the batch level)
    gm_ls = gamma.reshape(T, L * S)[..., None] * pos_post  # (T, LS, M)

    den_mix_pos = gamma.reshape(T, L * S).sum(0)  # (LS,)
    # shared single-pass moment GEMMs (train/em.gmm_moment_stats), grouped
    # over the L*S transcript positions
    w, x, xx = gmm_moment_stats(gm_ls, feats, tied.senones.cov_type)

    zero = lambda a: jnp.where(valid, a, jnp.zeros_like(a))
    return (
        StreamStats(w=zero(w), x=zero(x), xx=zero(xx)),
        zero(den_mix_pos),
        zero(xi_pos),
        zero(den_trans_pos),
        jnp.where(valid, log_z, 0.0),
        valid.astype(dtype),
    )


def tied_batch_stats(
    tied: TiedHmmSet,
    transcripts: jax.Array,
    feats: jax.Array,
    lengths: jax.Array,
):
    """Batch E-step statistics in senone/unit space: vmapped positional
    stats, then ONE scatter-add over the (B*L*S,) senone ids / (B*L,) unit
    ids.  Returns (senone StreamStats (N, ...), den_mix (N,),
    num_trans (P, S, S), den_trans (P, S), log_prob, num_valid)."""
    P, S, N = tied.num_units, tied.num_states, tied.num_senones
    B, L = transcripts.shape
    dtype = feats.dtype
    per = jax.vmap(
        lambda tr, f, l: tied_utterance_stats_positional(tied, tr, f, l)
    )(transcripts, feats, lengths)
    pos_stats, den_mix_pos, xi_pos, den_trans_pos, log_prob, valid = per

    sen_ids = tied.state_map[transcripts].reshape(B * L * S)  # (B*L*S,)
    seg = lambda vals: jnp.zeros((N,) + vals.shape[1:], dtype).at[sen_ids].add(vals)
    flat = lambda a: a.reshape(B * L * S, *a.shape[2:])
    sen_stats = StreamStats(
        w=seg(flat(pos_stats.w)), x=seg(flat(pos_stats.x)), xx=seg(flat(pos_stats.xx))
    )
    den_mix = seg(den_mix_pos.reshape(B * L * S))

    unit_ids = transcripts.reshape(B * L)
    num_trans = jnp.zeros((P, S, S), dtype).at[unit_ids].add(
        xi_pos.reshape(B * L, S, S)
    )
    den_trans = jnp.zeros((P, S), dtype).at[unit_ids].add(
        den_trans_pos.reshape(B * L, S)
    )
    return sen_stats, den_mix, num_trans, den_trans, log_prob.sum(), valid.sum()


def tied_batch_stats_sharded(
    tied: TiedHmmSet,
    transcripts: jax.Array,
    feats: jax.Array,
    lengths: jax.Array,
    mesh,
    axis: str = "data",
):
    """Data-parallel tied E-step: each device runs tied_batch_stats on its
    utterance shard and the senone/unit-space statistics psum over `axis`.
    Same return contract as tied_batch_stats."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    transcripts = jax.device_put(
        transcripts, NamedSharding(mesh, P(axis, None))
    )
    feats = jax.device_put(feats, NamedSharding(mesh, P(axis, None, None)))
    lengths = jax.device_put(lengths, NamedSharding(mesh, P(axis)))
    fn = _jitted_batch_stats_shard(
        tied_batch_stats, mesh, axis, jax.tree.structure(tied)
    )
    return fn(tied, transcripts, feats, lengths)


def tied_train_scan_sharded(
    tied: TiedHmmSet,
    packed,
    n_iters: int,
    mesh,
    axis: str = "data",
    var_floor: float = 0.0,
):
    """N DATA-PARALLEL tied EM iterations as ONE jitted
    shard_map(lax.scan) — the embedded.embedded_train_scan_sharded form
    for senone inventories: per-shard tied_batch_stats, senone-space psum
    inside the scan body, replicated tied update as the scan carry.

    packed: tuple of (transcripts, feats, lengths) shape buckets (the
    train_tied packing); every bucket batch must divide the mesh `axis`.
    Returns (final TiedHmmSet, (n_iters,) log-prob history, (n_iters,)
    num_valid history)."""
    sharded = shard_buckets(packed, mesh, axis)
    tied = _with_senone_log_det(tied)
    fn = _jitted_tied_sharded_scan(
        mesh, axis, n_iters, var_floor, jax.tree.structure(tied), len(sharded)
    )
    return fn(tied, sharded)


@lru_cache(maxsize=32)
def _jitted_tied_sharded_scan(mesh, axis, n_iters, var_floor, treedef, n_buckets):
    from jax.sharding import PartitionSpec as P

    tied_spec = jax.tree.unflatten(treedef, [P()] * treedef.num_leaves)
    bucket_spec = tuple(
        (P(axis, None), P(axis, None, None), P(axis))
        for _ in range(n_buckets)
    )

    def shard_fn(tied, packed):
        return _tied_scan(tied, packed, n_iters, var_floor, axis=axis)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(tied_spec, bucket_spec),
        out_specs=(tied_spec, P(), P()),
        # the lattice scans start from replicated carries; the psum of the
        # statistics establishes replication by construction
        check_vma=False,
    )
    return jax.jit(fn)


def _with_senone_log_det(tied: TiedHmmSet) -> TiedHmmSet:
    """Materialize the senones' log_det (a stable scan-carry structure)."""
    if tied.senones.log_det is not None:
        return tied
    return tied.replace(
        senones=tied.senones.replace(log_det=tied.senones.log_abs_det())
    )


@partial(jax.jit, static_argnames=("var_floor",))
def tied_em_step(
    tied: TiedHmmSet,
    transcripts: jax.Array,
    feats: jax.Array,
    lengths: jax.Array,
    var_floor: float = 0.0,
):
    """One tied-state embedded EM iteration over an equal-shape bucket.
    Returns (new TiedHmmSet, total log prob, num valid)."""
    stats = tied_batch_stats(tied, transcripts, feats, lengths)
    return _apply_tied_update(tied, stats, var_floor), stats[4], stats[5]


def _apply_tied_update(tied: TiedHmmSet, stats, var_floor: float) -> TiedHmmSet:
    """Tied M-step from aggregated statistics (shared by tied_em_step and
    the train_tied driver): senone emission update + per-unit banded
    transition row-normalization."""
    sen_stats, den_mix, num_trans, den_trans = stats[0], stats[1], stats[2], stats[3]
    senones = update_stream(tied.senones, sen_stats, den_mix, var_floor)
    band = (tied.trans > 0).astype(tied.trans.dtype)  # per-unit support mask
    trans_new = jnp.where(
        (den_trans > 0)[..., None],
        band * num_trans / jnp.where(den_trans > 0, den_trans, 1.0)[..., None],
        tied.trans,
    )
    return tied.replace(senones=senones, trans=trans_new)


def _tied_scan(tied, packed, k, var_floor, axis=None):
    """k tied EM iterations as one lax.scan over all shape buckets
    (statistics psum over `axis` when data-parallel)."""
    tied = _with_senone_log_det(tied)

    def step(t, _):
        agg = None
        for trs, feats, lengths in packed:
            st = tied_batch_stats(t, trs, feats, lengths)
            agg = st if agg is None else jax.tree.map(jnp.add, agg, st)
        if axis is not None:
            agg = jax.tree.map(lambda a: jax.lax.psum(a, axis), agg)
        return _apply_tied_update(t, agg, var_floor), (agg[4], agg[5])

    final, (lps, nvs) = jax.lax.scan(step, tied, None, length=k)
    return final, lps, nvs


@partial(jax.jit, static_argnames=("k", "var_floor"))
def _tied_chunk(tied, packed, k, var_floor):
    """k tied EM iterations in one program (the train/driver.py run_chunk
    contract)."""
    return _tied_scan(tied, packed, k, var_floor)


def train_tied(
    tied: TiedHmmSet,
    utterances: list[np.ndarray],
    transcripts: list[list[int]],
    threshold: float = 1e-3,
    max_iterations: int = 50,
    var_floor: float = 0.0,
    pad_multiple: int = 32,
    chunk: int = 8,
    mesh=None,
    mesh_axis: str = "data",
    checkpoint_dir=None,
    log_prob_offset: float = 0.0,
):
    """Tied-state embedded EM driver (bucketed by shape): iterations run
    in device-side scans of `chunk`, speculatively pipelined by the
    chunked convergence driver (train/driver.py), with the exact
    reference convergence semantics.

    mesh: optional Mesh with a `mesh_axis` axis — data-parallel training
    via tied_train_scan_sharded; buckets pad with empty
    utterances so every bucket batch divides the axis.

    checkpoint_dir: optional directory — chunk-granular checkpoint/resume
    through the driver (round 5): a config-5-scale tied run that dies
    resumes from the newest complete checkpoint with the identical
    trajectory instead of losing everything (the reference's failure
    mode, exit(1) T1:406-408)."""
    from ..io.dataset import round_up
    from .driver import chunked_convergence_train
    from .em_parity import TrainResult

    dtype = tied.trans.dtype
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, (u, tr) in enumerate(zip(utterances, transcripts)):
        buckets.setdefault((round_up(len(u), pad_multiple), len(tr)), []).append(i)
    n_dev = mesh.shape[mesh_axis] if mesh is not None else 1
    packed = []
    D = utterances[0].shape[1]
    for (T, L), idxs in buckets.items():
        nb = round_up(len(idxs), n_dev)  # empty-utterance pad rows for DP
        f = np.zeros((nb, T, D))
        ln = np.zeros(nb, np.int32)
        trs = np.zeros((nb, L), np.int32)
        for row, i in enumerate(idxs):
            f[row, : len(utterances[i])] = utterances[i]
            ln[row] = len(utterances[i])
            trs[row] = transcripts[i]
        packed.append((jnp.asarray(trs), jnp.asarray(f, dtype), jnp.asarray(ln)))

    if mesh is not None:
        run = lambda t, k: tied_train_scan_sharded(
            t, tuple(packed), k, mesh, axis=mesh_axis, var_floor=var_floor
        )
    else:
        run = lambda t, k: _tied_chunk(t, tuple(packed), k, var_floor)
    manager = None
    if checkpoint_dir is not None:
        from .checkpoint import CheckpointManager

        manager = CheckpointManager(checkpoint_dir)
        tied = _with_senone_log_det(tied)  # match the chunk-scan carry
    tied, iteration, history, n_valid = chunked_convergence_train(
        tied, run, threshold=threshold, max_iterations=max_iterations,
        chunk=chunk, checkpoint=manager, log_prob_offset=log_prob_offset,
    )
    return TrainResult(
        model=tied,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )
