"""Benchmark suite: the five BASELINE.json configurations.

  1. single word, 5 states, 1 diag Gaussian, MFCC-13 (reference-scale)
  2. 10-word isolated digits, 8 states, 4-mix diag, full Baum-Welch
  3. continuous digit strings: composed word HMMs + token-passing decode
  4. ~40 monophones, 32-mix GMMs, embedded re-estimation
  5. tied-state triphones, 2k states x 16 mixtures, mixture-sharded EM

Each config reports EM audio-seconds/s (or decode RTF for config 3) on the
GPU, with the platform, device kind and device count in every row; it
refuses to run without a GPU.  `python -m srhmm_tpu.bench.suite
[config...]` prints one JSON line per config.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

FRAME_SHIFT_S = 0.01


def _synth_utts(rng, B, T, D, S):
    state_means = rng.normal(size=(S, D)) * 5.0
    utts = []
    for _ in range(B):
        bounds = np.sort(rng.choice(np.arange(1, T), S - 1, replace=False))
        ids = np.zeros(T, dtype=int)
        for k, b in enumerate(bounds):
            ids[b:] = k + 1
        utts.append(state_means[ids] + rng.normal(size=(T, D)))
    return utts


def _rand_model(rng, S, M, D, dtype):
    import jax.numpy as jnp

    from ..models import DIAG, GmmHmm, GmmStream, init_left_right_trans

    means = rng.normal(size=(S, M, D)) * 3.0
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    return GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w),
                means=jnp.asarray(means),
                inv_cov=jnp.asarray(1.0 / var),
                det=jnp.asarray(np.prod(var, -1)),
                cov_type=DIAG,
            ),
        ),
    ).astype(dtype)


def device_row() -> dict:
    """What every benchmark row names: the platform, kind and count of the
    devices it ran on."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def _timed(fn, n):
    """(first-call seconds incl. compilation, steady seconds per call),
    each ending in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return compile_s, (time.perf_counter() - t0) / n


def _time_em(model, batch, iters=10):
    """Steady-state seconds per EM iteration on the production trainer:
    em_train_scan (N iterations as one jitted lax.scan) with the lattice
    implementation ops/backend.py picks."""
    from ..train.em import em_train_scan

    return _timed(lambda: em_train_scan(model, batch, iters), 3)[1] / iters


def recognition_vocab(cov_type: str = "diag", W=13, Sr=6, Dr=9):
    """A W-word reference-scale vocabulary (Sr states, 1 mixture, Dr dims),
    diagonal or full covariance, from fixed seeds."""
    import jax.numpy as jnp
    import numpy as np

    from ..models import (
        DIAG, FULL, GmmHmm, GmmStream, init_left_right_trans, stack_models,
    )

    def one(seed):
        r = np.random.default_rng(seed)
        means = r.normal(size=(Sr, 1, Dr)) * 4.0
        if cov_type == "full":
            a_rnd = r.normal(size=(Sr, 1, Dr, Dr)) * 0.3
            cov = a_rnd @ np.swapaxes(a_rnd, -1, -2) + np.eye(Dr)[None, None]
            inv_cov, det = np.linalg.inv(cov), np.linalg.det(cov)
            ct = FULL
        else:
            var = r.uniform(0.5, 1.5, size=(Sr, 1, Dr))
            inv_cov, det = 1.0 / var, np.prod(var, -1)
            ct = DIAG
        return GmmHmm(
            trans=init_left_right_trans(Sr),
            streams=(
                GmmStream(
                    weights=jnp.ones((Sr, 1)),
                    means=jnp.asarray(means),
                    inv_cov=jnp.asarray(inv_cov),
                    det=jnp.asarray(det),
                    cov_type=ct,
                ),
            ),
            word=f"w{seed}",
        )

    return stack_models([one(i) for i in range(W)]).astype(jnp.float32)


def recognition_batch(B=2048, T=500, D=9, seed=2):
    """B utterances of T frames (64 distinct ones, repeated)."""
    import jax.numpy as jnp
    import numpy as np

    from ..io.dataset import pack_utterances

    rng = np.random.default_rng(seed)
    return pack_utterances(
        [rng.normal(size=(T, D)) for _ in range(64)] * (B // 64),
        pad_multiple=128,
        dtype=jnp.float32,
    )


def config1(rng):
    """Reference-scale: 1 word, 5 states, 1 diag Gaussian, MFCC-13."""
    import jax.numpy as jnp

    from ..io.dataset import pack_utterances

    S, M, D, B, T = 5, 1, 13, 64, 300
    model = _rand_model(rng, S, M, D, jnp.float32)
    batch = pack_utterances(_synth_utts(rng, B, T, D, S), dtype=jnp.float32)
    dt = _time_em(model, batch)
    return {"config": 1, "metric": "em_audio_s_per_s",
            "value": B * T * FRAME_SHIFT_S / dt, **device_row()}


def config2(rng):
    """10-word digits, 8 states, 4-mix diag, full Baum-Welch."""
    import jax.numpy as jnp

    from ..io.dataset import pack_utterances

    S, M, D, B, T = 8, 4, 13, 256, 500
    model = _rand_model(rng, S, M, D, jnp.float32)
    batch = pack_utterances(_synth_utts(rng, B, T, D, S), dtype=jnp.float32)
    dt = _time_em(model, batch)
    return {"config": 2, "metric": "em_audio_s_per_s",
            "value": B * T * FRAME_SHIFT_S / dt, **device_row()}


def _vocab(rng, W, S, M, D):
    import jax.numpy as jnp

    from ..models import stack_models

    return stack_models(
        [_rand_model(rng, S, M, D, jnp.float32).replace(word=f"w{i}")
         for i in range(W)]
    )


def _decode_rtf(rng, W, S, M, D, T, n=20):
    """Continuous-decode RTF of one utterance on a W-word loop (block token
    passing)."""
    import jax
    import jax.numpy as jnp

    from ..decode.continuous import (
        compose_word_loop_blocks,
        composed_emissions,
        token_passing_blocks,
    )

    vocab = _vocab(rng, W, S, M, D)
    graph = compose_word_loop_blocks(vocab)
    frames = jnp.asarray(rng.normal(size=(T, D)), jnp.float32)
    decode = jax.jit(
        lambda f: token_passing_blocks(graph, composed_emissions(vocab, f))
    )
    return _timed(lambda: decode(frames), n)[1] / (T * FRAME_SHIFT_S)


def _batch_decode_rtf(rng, W, S, M, D, T, B=128, n=3, bigram=False, n_best=1):
    """Per-audio-second time of the batched decoder
    (decode_continuous_batch: B utterances in one program, backtrace and
    host word extraction included)."""
    import jax.numpy as jnp

    from ..decode.continuous import decode_continuous_batch
    from ..io.dataset import UtteranceBatch

    vocab = _vocab(rng, W, S, M, D)
    lm = np.log(rng.dirichlet(np.ones(W), size=W)) if bigram else None
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    batch = UtteranceBatch(features=feats, lengths=jnp.full((B,), T, jnp.int32))
    run = lambda: decode_continuous_batch(
        vocab, batch, lm_logprobs=lm, n_best=n_best
    )
    return _timed(run, n)[1] / (B * T * FRAME_SHIFT_S)


def config3(rng):
    """Continuous strings: composed word-loop token-passing decode RTF at
    W=10 (BASELINE config) and W=200, one utterance on the block engine and
    128 utterances on the batched decoder (bigram LM, 1- and 2-best)."""
    rtf10 = _decode_rtf(rng, W=10, S=8, M=4, D=13, T=1000)
    rtf200 = _decode_rtf(rng, W=200, S=8, M=4, D=13, T=1000)
    out = {"config": 3, "metric": "decode_rtf", "value": rtf10,
           "decode_rtf_w200": rtf200}
    for k in (1, 2):
        out[f"batch_bigram_k{k}_rtf_w200"] = _batch_decode_rtf(
            rng, W=200, S=8, M=4, D=13, T=1000, bigram=True, n_best=k
        )
    return {**out, **device_row()}


def config4(rng):
    """~40 monophones, 32-mix GMMs, embedded re-estimation."""
    import jax.numpy as jnp

    from ..models import stack_models
    from ..train.embedded import _embedded_chunk

    P, S, M, D = 40, 3, 32, 13
    B, T, L = 512, 512, 12
    units = [_rand_model(rng, S, M, D, jnp.float32).replace(word=f"p{i}") for i in range(P)]
    models = stack_models(units)
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lengths = jnp.full((B,), T, jnp.int32)

    # the train_embedded driver's chunk: k iterations as one device scan
    packed = ((transcripts, feats, lengths),)
    k = 10
    dt = _timed(lambda: _embedded_chunk(models, packed, k, 0.0), 3)[1] / k
    return {"config": 4, "metric": "em_audio_s_per_s",
            "value": B * T * FRAME_SHIFT_S / dt, **device_row()}


CONFIG5 = dict(P=700, S=3, M=16, D=39, N=2000, B=1024, T=304, L=10)


def config5_data(rng, B=None):
    """Config 5's tied system and one bucket of utterances: 700
    context-dependent units (3 states each) sharing a 2000-senone x
    16-mixture inventory on 39-dim features, B utterances of T=304 frames
    with L=10-unit transcripts.  Returns (tied, transcripts, feats,
    lengths)."""
    import jax.numpy as jnp

    from ..models import stack_models
    from ..models.tying import tie_from_models

    c = CONFIG5
    P, S, M, D, N, T, L = (c[k] for k in "PSMDNTL")
    B = c["B"] if B is None else B
    units = [
        _rand_model(np.random.default_rng(1000 + i), S, M, D, jnp.float32)
        .replace(word=f"tri{i}")
        for i in range(P)
    ]
    sm = rng.integers(0, N, size=(P, S)).astype(np.int32)
    cover = -(-N // S)  # enough units to touch every senone id at least once
    sm[:cover, :] = np.minimum(np.arange(cover * S).reshape(-1, S), N - 1)
    tied = tie_from_models(stack_models(units), sm).astype(jnp.float32)
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lengths = jnp.full((B,), T, jnp.int32)
    return tied, transcripts, feats, lengths


def config5(rng):
    """Tied-state triphones: 2k senones x 16 mixtures, tied embedded EM;
    senone-space statistics are the all-reduce payload on a multi-device
    mesh."""
    from ..train.tied import _tied_chunk

    tied, transcripts, feats, lengths = config5_data(rng)
    c = CONFIG5
    # the train_tied driver's chunk: k iterations as one device scan
    packed = ((transcripts, feats, lengths),)
    k = 10
    dt = _timed(lambda: _tied_chunk(tied, packed, k, 0.1), 3)[1] / k
    return {"config": 5, "metric": "em_audio_s_per_s",
            "value": c["B"] * c["T"] * FRAME_SHIFT_S / dt,
            "senones": c["N"], "units": c["P"], **device_row()}


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def main(argv=None):
    import jax

    from ..ops.backend import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench/suite.py measures the GPU; JAX found {jax.devices()}"
        )
    enable_compile_cache()
    argv = argv if argv is not None else sys.argv[1:]
    which = [int(a) for a in argv] or [1, 2, 3]
    rng = np.random.default_rng(0)
    for c in which:
        out = CONFIGS[c](rng)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
