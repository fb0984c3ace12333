"""Padded utterance batching for the device.

The reference streams one utterance at a time, re-reading each .perfil from
disk twice per EM iteration (T1:259, T1:287).  This design loads a
training list once into a padded (B, T_max, D) device array with a lengths
vector; every downstream op (emission GEMMs, forward/backward scans, EM
statistics) is masked by `lengths` so padding contributes nothing.

Padding is bucketed to multiples of `pad_multiple` so recompilation is
bounded: XLA compiles once per (bucket, D) shape, not once per utterance
length (static-shape jit contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree


@pytree.dataclass
class UtteranceBatch:
    """features: (B, T_max, D); lengths: (B,) int32."""

    features: jax.Array
    lengths: jax.Array

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def max_frames(self) -> int:
        return self.features.shape[1]

    def mask(self) -> jax.Array:
        """(B, T_max) True on valid frames."""
        t = jnp.arange(self.max_frames)[None, :]
        return t < self.lengths[:, None]


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_utterances(
    utterances: list[np.ndarray],
    pad_multiple: int = 128,
    pad_batch_to: int | None = None,
    dtype=jnp.float32,
) -> UtteranceBatch:
    """Pack variable-length utterances into a padded batch.

    Batch padding (pad_batch_to) adds zero-length dummy utterances so the
    batch axis is shardable across a device mesh; zero-length rows produce
    zero sufficient statistics and -inf scores.
    """
    if not utterances:
        raise ValueError("empty utterance list")
    D = utterances[0].shape[1]
    T = round_up(max(u.shape[0] for u in utterances), pad_multiple)
    B = len(utterances)
    if pad_batch_to is not None:
        B = max(B, pad_batch_to)
    feats = np.zeros((B, T, D), dtype=np.float64)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, u in enumerate(utterances):
        feats[i, : u.shape[0]] = u
        lengths[i] = u.shape[0]
    return UtteranceBatch(
        features=jnp.asarray(feats, dtype=dtype), lengths=jnp.asarray(lengths)
    )


def load_batch(
    list_path: str | Path,
    relative_to: str | Path | None = None,
    pad_multiple: int = 128,
    pad_batch_to: int | None = None,
    dtype=jnp.float32,
    native: bool | None = None,
) -> UtteranceBatch:
    """Read every .perfil in a list file into one padded batch.

    native=None (default) uses the C++ worker-pool loader
    (native/loader.cpp via io/native_loader.py) when it can be built —
    one pass to scan headers, one threaded pass straight into the padded
    array — and falls back to the pure-Python reader otherwise.
    native=False forces the Python reader (bit-parity-critical callers).
    """
    from .lists import read_list

    base = Path(relative_to) if relative_to is not None else Path(".")
    paths = [str(base / p) for p in read_list(list_path)]

    if native is None or native:
        from .native_loader import load_batch_native, native_available, scan_perfil

        if native_available():
            shapes = scan_perfil(paths)
            if (shapes[:, 0] > 0).all():
                dims = set(int(d) for d in shapes[:, 1])
                if len(dims) != 1:
                    raise ValueError(f"{list_path}: mixed feature dims {dims}")
                dim = dims.pop()
                t_max = round_up(int(shapes[:, 0].max()), pad_multiple)
                np_dtype = np.dtype(jnp.dtype(dtype).name)
                if np_dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
                    np_dtype = np.dtype(np.float64)
                feats, lengths = load_batch_native(
                    paths, t_max, dim, dtype=np_dtype.type
                )
                if pad_batch_to is not None and len(paths) < pad_batch_to:
                    extra = pad_batch_to - len(paths)
                    feats = np.concatenate(
                        [feats, np.zeros((extra, t_max, dim), feats.dtype)], 0
                    )
                    lengths = np.concatenate(
                        [lengths, np.zeros((extra,), lengths.dtype)], 0
                    )
                return UtteranceBatch(
                    features=jnp.asarray(feats, dtype=dtype),
                    lengths=jnp.asarray(lengths.astype(np.int32)),
                )
            if native:
                raise IOError(f"{list_path}: native loader failed to scan inputs")

    from .perfil import read_perfil

    utts = [read_perfil(p) for p in paths]
    return pack_utterances(utts, pad_multiple, pad_batch_to, dtype)
