"""Device-mesh parallelism for EM training and batch scoring.

The reference is strictly single-threaded, single-process C (SURVEY §2.4); the
replacements are:

* **Data parallelism** — utterance batches sharded over a `data` mesh axis.
  EM sufficient statistics are linear in the data, so the E-step's sum over
  the batch axis IS the psum: under jit, with inputs placed via NamedSharding
  and the model replicated, GSPMD partitions the per-utterance work and
  inserts the all-reduce for the stats reduction automatically.
* **Model (mixture) parallelism** — the Gaussian-mixture axis M of each
  stream sharded over a `model` mesh axis (BASELINE.json config 5:
  mixture-sharded multi-host EM).  Per-state logsumexp over M and the
  M-axis statistics reductions become cross-shard collectives, again
  inserted by GSPMD from the sharding annotations.
* Multi-host bootstrap is `jax.distributed.initialize` (not wrapped here);
  the mesh helpers below take whatever `jax.devices()` shows.

Design note: we deliberately use sharding annotations + GSPMD propagation
rather than hand-written shard_map psums — XLA already emits the minimal
collective schedule for linear statistics, and the same code runs unsharded
on one device.  (The explicit shard_map trainers — train/em.py
em_train_scan_sharded and the embedded/tied forms — exist because the GPU
lattice kernel is a pallas_call, which GSPMD cannot partition.)
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.dataset import UtteranceBatch
from ..models.gmm_hmm import FULL, GmmHmm, GmmStream

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: int | None = None, n_model: int = 1, devices=None
) -> Mesh:
    """A (data, model) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} devices not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def shard_batch(batch: UtteranceBatch, mesh: Mesh) -> UtteranceBatch:
    """Place a padded batch with the batch axis sharded over `data`.

    The batch size must be divisible by the data-axis size (pad_batch_to in
    io/dataset.py adds zero-length rows, which contribute zero statistics).
    """
    feat_sh = NamedSharding(mesh, P(DATA_AXIS, None, None))
    len_sh = NamedSharding(mesh, P(DATA_AXIS))
    return UtteranceBatch(
        features=jax.device_put(batch.features, feat_sh),
        lengths=jax.device_put(batch.lengths, len_sh),
    )


def _stream_specs(stream: GmmStream, shard_mixtures: bool) -> GmmStream:
    m = MODEL_AXIS if shard_mixtures else None
    return GmmStream(
        weights=P(None, m),
        means=P(None, m, None),
        inv_cov=P(None, m, None, None) if stream.cov_type == FULL else P(None, m, None),
        det=P(None, m),
        cov_type=stream.cov_type,
        log_det=None if stream.log_det is None else P(None, m),
    )


def shard_model(
    model: GmmHmm, mesh: Mesh, shard_mixtures: bool | None = None
) -> GmmHmm:
    """Place model parameters: transitions replicated; mixture axis sharded
    over `model` when that axis has more than one device."""
    if shard_mixtures is None:
        shard_mixtures = mesh.shape[MODEL_AXIS] > 1
    spec = GmmHmm(
        trans=P(),
        streams=tuple(_stream_specs(s, shard_mixtures) for s in model.streams),
        word=model.word,
    )
    return jax.tree.map(
        lambda x, sp: None if x is None else jax.device_put(x, NamedSharding(mesh, sp)),
        model,
        spec,
        is_leaf=lambda x: x is None,
    )


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def em_step_sharded(model: GmmHmm, batch: UtteranceBatch, var_floor: float = 0.0):
    """One EM iteration over sharded inputs.  Identical code to
    train.em.em_step — the sharding of `model` and `batch` drives GSPMD; the
    stats sum over the batch axis lowers to an all-reduce."""
    from ..train.em import em_step

    return em_step(model, batch, var_floor)
