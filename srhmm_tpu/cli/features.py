"""Feature-extraction CLI: WAV -> MFCC written as reference-compatible
`.perfil` files (a capability the reference lacks — it consumes precomputed
features with no extraction code, SURVEY §2.6).

Usage:
    python -m srhmm_tpu.cli.features wav_list out_dir
        [--n-mfcc 13] [--n-mels 26] [--frame-length 400] [--frame-shift 160]

wav_list: one 16-bit PCM WAV path per line; each produces
out_dir/<stem>.perfil holding float64 MFCC frames.
"""

from __future__ import annotations

import argparse
import sys
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """16-bit PCM WAV -> (float waveform in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM supported")
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype="<i2").astype(np.float64)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
        return data / 32768.0, w.getframerate()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav_list")
    ap.add_argument("out_dir")
    ap.add_argument("--n-mfcc", type=int, default=13)
    ap.add_argument("--n-mels", type=int, default=26)
    ap.add_argument("--frame-length", type=int, default=400)
    ap.add_argument("--frame-shift", type=int, default=160)
    ns = ap.parse_args(argv)

    import jax.numpy as jnp

    from ..features import FrontendConfig, mfcc
    from ..io import read_list, write_perfil

    out_dir = Path(ns.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    for wav_path in read_list(ns.wav_list):
        x, sr = read_wav(wav_path)
        cfg = FrontendConfig(
            sample_rate=sr,
            frame_length=ns.frame_length,
            frame_shift=ns.frame_shift,
            n_mels=ns.n_mels,
            n_mfcc=ns.n_mfcc,
        )
        feats = np.asarray(mfcc(jnp.asarray(x), cfg))
        out = out_dir / (Path(wav_path).stem + ".perfil")
        write_perfil(out, feats.astype(np.float64))
        print(f"{wav_path} -> {out} ({feats.shape[0]} frames x {feats.shape[1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
