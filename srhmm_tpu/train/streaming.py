"""Streaming EM: datasets larger than device memory, with async prefetch.

EM sufficient statistics are linear in the data, so an iteration over a
dataset that does not fit HBM is a sum of per-shard E-steps: stream the
shards through the device (io/pipeline.PrefetchLoader double-buffers the
load/H2D of shard k+1 behind the compute of shard k), accumulate the
SuffStats on device, and run one M-step.  This is the input-pipeline
answer to the reference's in-loop blocking stdio reads (T1:258-269; see
io/pipeline.py) at the scale where `train_fast`'s single resident batch
stops fitting.

The per-iteration host sync (the reference convergence rule) is free
here: each iteration already walks the whole dataset, which costs far
more than one round trip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..io.dataset import UtteranceBatch
from ..io.pipeline import device_put_loader
from ..models.gmm_hmm import GmmHmm
from .em import _lattice_for, _with_log_det, e_step, m_step


_e_step_jit = jax.jit(e_step, static_argnames=("bf16_stats", "lattice"))
_m_step_jit2 = jax.jit(
    m_step, static_argnames=("var_floor",)
)


def em_step_streaming(
    model: GmmHmm,
    loader,
    var_floor: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """One EM iteration over a stream of UtteranceBatch shards.

    loader: an iterable of device-resident UtteranceBatch (typically a
    PrefetchLoader, so shard k+1 loads while shard k computes).  All
    shards should share (B, T) to avoid recompiles (pad the tail shard).
    Returns (new_model, total_log_prob, num_valid)."""
    agg = None
    for batch in loader:
        st = _e_step_jit(model, batch, lattice=_lattice_for(batch))
        agg = st if agg is None else jax.tree.map(jnp.add, agg, st)
    if agg is None:
        raise ValueError("em_step_streaming: empty loader")
    new_model = _m_step_jit2(
        model, agg, var_floor=var_floor, abs_floors=abs_floors,
        zero_det_thresholds=zero_det_thresholds,
    )
    return new_model, agg.log_prob, agg.num_valid


def train_streaming(
    model: GmmHmm,
    host_shards,
    threshold: float = 1.0e-3,
    max_iterations: int = 100,
    var_floor: float = 0.0,
    depth: int = 2,
    log_prob_offset: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """EM driver with the reference convergence rule over sharded data.

    host_shards: list of UtteranceBatch whose arrays live on the HOST
    (numpy); each iteration streams them through a fresh
    io/pipeline.device_put_loader so the H2D copy of shard k+1 overlaps
    the E-step of shard k.  Semantically identical to `train_fast` on the
    concatenated batch (statistics are summed in shard order)."""
    from .em_parity import TrainResult

    model = _with_log_det(model)
    old = 1.0
    history: list[float] = []
    iteration = 0
    n_valid = 0
    while iteration < max_iterations:
        iteration += 1
        loader = device_put_loader(host_shards, depth=depth)
        new_model, log_prob, num_valid = em_step_streaming(
            model, loader, var_floor=var_floor, abs_floors=abs_floors,
            zero_det_thresholds=zero_det_thresholds,
        )
        lp = float(log_prob) + log_prob_offset
        n_valid = int(num_valid)
        history.append(lp)
        if old != 0.0 and abs((old - lp) / old) <= threshold:
            break
        old = lp
        model = new_model
    return TrainResult(
        model=model,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )


def shard_batch(batch: UtteranceBatch, n_shards: int):
    """Split a host UtteranceBatch into n roughly-equal shards along the
    batch axis (numpy views; equal (T, D) so the streaming E-step compiles
    once).  Shards keep a common batch size by zero-length padding the
    tail (inert rows)."""
    import numpy as np

    feats = np.asarray(batch.features)
    lengths = np.asarray(batch.lengths)
    B = feats.shape[0]
    n_shards = max(1, min(n_shards, B))
    per = -(-B // n_shards)
    shards = []
    for i in range(0, B, per):
        f = feats[i : i + per]
        ln = lengths[i : i + per]
        if f.shape[0] < per:  # pad the tail shard to the common shape
            pad = per - f.shape[0]
            f = np.concatenate([f, np.zeros((pad,) + f.shape[1:], f.dtype)])
            ln = np.concatenate([ln, np.zeros((pad,), ln.dtype)])
        shards.append(UtteranceBatch(features=f, lengths=ln))
    return shards
