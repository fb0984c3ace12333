"""MFCC / log-mel filterbank frontend — GEMM-native.

The reference consumes precomputed 9-dim spectral-profile features and ships
no feature extraction at all (SURVEY §2.6: `.perfil` holds band energies);
this module supplies the missing frontend named in BASELINE.json's north star
("MFCC/filterbank feature extraction as a ... STFT+DCT kernel").

Design: every stage is a matrix multiply against a precomputed constant, so
the whole pipeline is a chain of GEMMs (the GEMM-native NDFT formulation —
cf. the MelT paper, PAPERS.md), run at the float32 precision policy of
ops/backend.py:

    frames (B, F, W)  @ [window * DFT cos/sin] (W, K)   -> real/imag spectra
    power  (B, F, K)  @ mel filterbank         (K, n_mels)
    log-mel (B, F, n_mels) @ DCT-II            (n_mels, n_mfcc)

No FFT is used: for speech window sizes (W = 400..1024) a dense DFT matmul
fuses with windowing and needs no power-of-2 padding.  Deltas are a depthwise
convolution expressed as a banded matmul over time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.backend import PRECISION


def _mm(a, b):
    return jnp.matmul(a, b, precision=PRECISION)


@dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16_000
    frame_length: int = 400  # 25 ms
    frame_shift: int = 160  # 10 ms
    n_mels: int = 26
    n_mfcc: int = 13
    fmin: float = 20.0
    fmax: float | None = None  # default sr/2
    preemphasis: float = 0.97
    window: str = "hamming"  # hamming | hann | rect
    log_floor: float = 1e-10
    include_energy: bool = False


def _window(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    if cfg.window == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    if cfg.window == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    if cfg.window == "rect":
        return np.ones(n)
    raise ValueError(cfg.window)


def dft_matrices(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT as two (W, K) matmul constants (cos, -sin)."""
    W = cfg.frame_length
    K = W // 2 + 1
    n = np.arange(W)[:, None]
    k = np.arange(K)[None, :]
    ang = 2.0 * np.pi * n * k / W
    win = _window(cfg)[:, None]
    return (np.cos(ang) * win, -np.sin(ang) * win)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """(K, n_mels) triangular mel filterbank (HTK mel scale)."""
    K = cfg.frame_length // 2 + 1
    fmax = cfg.fmax or cfg.sample_rate / 2.0
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    pts = imel(np.linspace(mel(cfg.fmin), mel(fmax), cfg.n_mels + 2))
    bins = pts / (cfg.sample_rate / 2.0) * (K - 1)
    fb = np.zeros((K, cfg.n_mels))
    for m in range(cfg.n_mels):
        l, c, r = bins[m], bins[m + 1], bins[m + 2]
        k = np.arange(K)
        up = (k - l) / max(c - l, 1e-9)
        down = (r - k) / max(r - c, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def dct_matrix(cfg: FrontendConfig) -> np.ndarray:
    """(n_mels, n_mfcc) orthonormal DCT-II (drops c0 when include_energy)."""
    n, k = np.meshgrid(np.arange(cfg.n_mels), np.arange(cfg.n_mfcc), indexing="ij")
    d = np.cos(np.pi * (n + 0.5) * k / cfg.n_mels) * math.sqrt(2.0 / cfg.n_mels)
    d[:, 0] *= math.sqrt(0.5)
    return d


def frame_signal(x: jax.Array, cfg: FrontendConfig) -> jax.Array:
    """(..., N) -> (..., F, W) overlapping frames (gather-free: strided
    reshape via dynamic_slice windows is compiled into one copy by XLA)."""
    N = x.shape[-1]
    F = 1 + max(0, (N - cfg.frame_length)) // cfg.frame_shift
    idx = (
        np.arange(F)[:, None] * cfg.frame_shift + np.arange(cfg.frame_length)[None, :]
    )
    return x[..., idx]


@partial(jax.jit, static_argnames=("cfg",))
def mfcc(x: jax.Array, cfg: FrontendConfig = FrontendConfig()) -> jax.Array:
    """Waveform (..., N) -> MFCC (..., F, n_mfcc).  All-GEMM pipeline."""
    dtype = x.dtype
    if cfg.preemphasis:
        x = jnp.concatenate(
            [x[..., :1], x[..., 1:] - cfg.preemphasis * x[..., :-1]], axis=-1
        )
    frames = frame_signal(x, cfg)  # (..., F, W)
    cos_m, sin_m = dft_matrices(cfg)
    re = _mm(frames, jnp.asarray(cos_m, dtype))
    im = _mm(frames, jnp.asarray(sin_m, dtype))
    power = re * re + im * im  # (..., F, K)
    melspec = _mm(power, jnp.asarray(mel_filterbank(cfg), dtype))
    logmel = jnp.log(jnp.maximum(melspec, cfg.log_floor))
    out = _mm(logmel, jnp.asarray(dct_matrix(cfg), dtype))
    if cfg.include_energy:
        energy = jnp.log(jnp.maximum(jnp.sum(power, -1), cfg.log_floor))
        out = out.at[..., 0].set(energy)
    return out


@partial(jax.jit, static_argnames=("cfg",))
def log_mel(x: jax.Array, cfg: FrontendConfig = FrontendConfig()) -> jax.Array:
    """Waveform (..., N) -> log-mel filterbank (..., F, n_mels)."""
    dtype = x.dtype
    if cfg.preemphasis:
        x = jnp.concatenate(
            [x[..., :1], x[..., 1:] - cfg.preemphasis * x[..., :-1]], axis=-1
        )
    frames = frame_signal(x, cfg)
    cos_m, sin_m = dft_matrices(cfg)
    re = _mm(frames, jnp.asarray(cos_m, dtype))
    im = _mm(frames, jnp.asarray(sin_m, dtype))
    power = re * re + im * im
    melspec = _mm(power, jnp.asarray(mel_filterbank(cfg), dtype))
    return jnp.log(jnp.maximum(melspec, cfg.log_floor))


def delta_matrix(T: int, order_window: int = 2, dtype=np.float64) -> np.ndarray:
    """(T, T) banded regression-delta operator (HTK-style, edge-replicated):
    deltas as one matmul over the time axis."""
    N = order_window
    denom = 2.0 * sum(n * n for n in range(1, N + 1))
    m = np.zeros((T, T), dtype=dtype)
    for t in range(T):
        for n in range(1, N + 1):
            m[t, min(t + n, T - 1)] += n / denom
            m[t, max(t - n, 0)] -= n / denom
    return m


@partial(jax.jit, static_argnames=("order_window",))
def add_deltas(feats: jax.Array, order_window: int = 2) -> jax.Array:
    """(..., T, D) -> (..., T, 3D): static + delta + delta-delta."""
    T = feats.shape[-2]
    dm = jnp.asarray(delta_matrix(T, order_window), feats.dtype)
    d1 = jnp.einsum("ts,...sd->...td", dm, feats, precision=PRECISION)
    d2 = jnp.einsum("ts,...sd->...td", dm, d1, precision=PRECISION)
    return jnp.concatenate([feats, d1, d2], axis=-1)


@partial(jax.jit, static_argnames=("var_norm",))
def cmvn(
    feats: jax.Array,
    lengths: jax.Array | None = None,
    var_norm: bool = True,
    eps: float = 1.0e-8,
) -> jax.Array:
    """Per-utterance cepstral mean (and variance) normalization.

    feats: (..., T, D); lengths: optional (...,) valid frame counts for
    padded batches — statistics are computed over valid frames only and
    padded frames pass through untouched (so downstream masked scans see the
    same padding they were given).  Standard speech-frontend component; the
    reference has no frontend at all (SURVEY §2.6 — it consumes precomputed
    .perfil features)."""
    if lengths is None:
        mean = jnp.mean(feats, axis=-2, keepdims=True)
        centered = feats - mean
        if not var_norm:
            return centered
        var = jnp.mean(centered * centered, axis=-2, keepdims=True)
        return centered * jax.lax.rsqrt(var + eps)
    T = feats.shape[-2]
    mask = (
        jnp.arange(T) < lengths[..., None]
    )[..., None].astype(feats.dtype)  # (..., T, 1)
    n = jnp.maximum(lengths[..., None, None].astype(feats.dtype), 1.0)
    mean = jnp.sum(feats * mask, axis=-2, keepdims=True) / n
    centered = (feats - mean) * mask
    if var_norm:
        var = jnp.sum(centered * centered, axis=-2, keepdims=True) / n
        centered = centered * jax.lax.rsqrt(var + eps)
    return jnp.where(mask > 0, centered, feats)


def global_cmvn_stats(
    feats: jax.Array, lengths: jax.Array | None = None, eps: float = 1.0e-8
):
    """Corpus-level mean/std over the valid frames of a padded (B, T, D)
    batch.  Returns ((D,) mean, (D,) std) in float64 host precision.

    This is the fast trainer's PRECISION lever (PERF.md "Accuracy"): EM is
    exactly equivariant under the affine map y = (x - mean)/std (densities
    pick up a constant Jacobian, occupancies are unchanged), so training in
    normalized space and de-normalizing the result (models.gmm_hmm
    .denormalize_model) reproduces raw-space training — but the f32 moment
    GEMMs now round relative to O(1) magnitudes instead of the raw feature
    scale (the .perfil profiles reach |x| ~ 3e3, where f32 second moments
    lose ~mean^2/variance of their precision)."""
    import numpy as np

    f = np.asarray(feats, np.float64)
    if f.ndim == 2:
        f = f[None]
    if lengths is None:
        valid = np.ones(f.shape[:2], bool)
    else:
        ln = np.asarray(lengths).reshape(-1)
        valid = np.arange(f.shape[1])[None, :] < ln[:, None]
    sel = f[valid]  # (n_frames, D)
    mean = sel.mean(0)
    std = np.sqrt(np.maximum(sel.var(0), eps))
    return mean, std
