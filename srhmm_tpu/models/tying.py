"""Tied-state (senone) model sets.

BASELINE.json config 5 is a tied-state triphone system: many context-
dependent HMMs whose emission states SHARE a much smaller inventory of
Gaussian-mixture distributions (senones).  The reference has nothing like
this (one private GMM per state); this design keeps a single
senone GmmStream of shape (N, M, ...) plus an integer map
(unit, state) -> senone, so

  * senone emissions for a whole utterance are ONE merged computation
    (T x N·M GEMM for diag covariance) regardless of how many units share
    them, and
  * EM statistics scatter-add into the senone inventory — tying IS the
    scatter; mixture-sharded model parallelism shards the senone axis.

`materialize()` expands to a stacked per-unit GmmHmm (gathering senone
parameters) so every existing decode/scoring path works unchanged on tied
systems.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from .gmm_hmm import GmmHmm, GmmStream


@pytree.dataclass
class TiedHmmSet:
    """senones: (N, M, ...) shared emission states; trans: (P, S, S) per-unit
    transitions; state_map: (P, S) int32 senone ids."""

    senones: GmmStream
    trans: jax.Array
    state_map: jax.Array
    unit_names: Any = pytree.static_field(default=())

    @property
    def num_units(self) -> int:
        return self.trans.shape[0]

    @property
    def num_states(self) -> int:
        return self.trans.shape[-1]

    @property
    def num_senones(self) -> int:
        return self.senones.weights.shape[0]

    def log_trans(self) -> jax.Array:
        t = self.trans
        return jnp.where(t > 0, jnp.log(jnp.where(t > 0, t, 1.0)), -jnp.inf)

    def materialize(self) -> GmmHmm:
        """Expand to a stacked per-unit GmmHmm (P, S, M, ...) by gathering
        senone parameters — for use with the existing decode machinery."""
        sm = self.state_map
        take = lambda a: a[sm]
        stream = GmmStream(
            weights=take(self.senones.weights),
            means=take(self.senones.means),
            inv_cov=take(self.senones.inv_cov),
            det=take(self.senones.det),
            cov_type=self.senones.cov_type,
            log_det=None if self.senones.log_det is None else take(self.senones.log_det),
        )
        return GmmHmm(trans=self.trans, streams=(stream,), word=self.unit_names)

    def astype(self, dtype) -> "TiedHmmSet":
        return TiedHmmSet(
            senones=self.senones.astype(dtype),
            trans=self.trans.astype(dtype),
            state_map=self.state_map,
            unit_names=self.unit_names,
        )


def untied_state_map(num_units: int, num_states: int) -> jnp.ndarray:
    """The no-sharing map: senone id = unit * S + state (N = P*S)."""
    return jnp.arange(num_units * num_states, dtype=jnp.int32).reshape(
        num_units, num_states
    )


def tie_from_models(models: GmmHmm, state_map: np.ndarray) -> TiedHmmSet:
    """Build a tied set from a stacked per-unit GmmHmm by averaging the
    parameters of states mapped to the same senone (a simple seeding scheme;
    proper decision-tree clustering is a modeling choice layered on top)."""
    stream = models.streams[0]
    sm = np.asarray(state_map)
    N = int(sm.max()) + 1
    P, S = sm.shape

    def pool(a):
        a = np.asarray(a, np.float64)
        flat = a.reshape(P * S, *a.shape[2:])
        out = np.zeros((N, *a.shape[2:]))
        cnt = np.zeros(N)
        np.add.at(out, sm.reshape(-1), flat)
        np.add.at(cnt, sm.reshape(-1), 1.0)
        return out / cnt.reshape(-1, *([1] * (a.ndim - 2)))

    weights = pool(stream.weights)
    weights = weights / weights.sum(-1, keepdims=True)
    means = pool(stream.means)
    if stream.cov_type == "full":
        # pool covariances (not inverses): invert the pooled inverse is wrong;
        # for seeding, pool the inverses then re-derive det from them
        inv = pool(stream.inv_cov)
        det = 1.0 / np.abs(np.linalg.det(inv))
    else:
        inv = pool(stream.inv_cov)
        det = np.prod(1.0 / inv, axis=-1)
    senones = GmmStream(
        weights=jnp.asarray(weights),
        means=jnp.asarray(means),
        inv_cov=jnp.asarray(inv),
        det=jnp.asarray(det),
        cov_type=stream.cov_type,
    )
    return TiedHmmSet(
        senones=senones,
        trans=models.trans,
        state_map=jnp.asarray(sm, jnp.int32),
        unit_names=models.word,
    )
