#!/usr/bin/env python3
"""Headline benchmarks on the GPU.  Prints one JSON line per metric, each
naming the platform, device kind and device count it ran on; the FINAL line
is the headline EM-training metric with the decode RTF attached.  Exits
with an error when JAX finds no GPU.

1. EM training throughput (audio-seconds of speech processed per second of
   wall time, steady-state per-iteration):
   * workload: diagonal-covariance GMM-HMM, 8 states, 3 mixtures/state,
     9-dim features, 500-frame utterances (10 ms shift -> 5 s audio each) —
     within the reference C's compile-time limits so the baseline can run
     the identical job.
   * ours: train/em.py em_train_scan, f32, B=2048 batch.
   * baseline: the reference diag trainer (train/source/hmm-fs/
     hmm_continuous_fs.c) compiled -O2 on the host CPU; per-iteration
     time = EM wall time / iterations (cached in .bench_baseline.json).

2. Viterbi decode RTF: continuous token-passing decode (block engine,
   decode/continuous.py) over a 13-word loop of reference-scale models
   (6 states, 1 mixture, 9-dim) — real-time factor = decode seconds per
   audio second.  Baseline: the C recognizer's implied RTF 0.021
   (hmm-result.txt: 0.03 s per 1.42 s utterance; BASELINE.md).

3. Batch recognition (decode/scorer.score_batch), diagonal and full
   covariance, and all five suite configs (bench/suite.py).
"""

import json
import pathlib
import shutil
import struct
import subprocess
import time

REPO = pathlib.Path(__file__).resolve().parent
CACHE = REPO / ".bench_baseline.json"
REF_SRC = pathlib.Path("/root/reference/train/source/hmm-fs/hmm_continuous_fs.c")

S, M, D, B, T = 8, 3, 9, 64, 500  # C-baseline job (within its limits)
OUR_B = 2048  # our side runs the same per-frame workload over a larger
             # data-parallel batch; audio-seconds/s is batch-normalized
FRAME_SHIFT_S = 0.01
AUDIO_SECONDS = B * T * FRAME_SHIFT_S  # per C EM iteration
BASELINE_DECODE_RTF = 0.021  # hmm-result.txt:182-183 (BASELINE.md row 4)


def make_dataset(seed=0):
    """Synthetic utterances from a wandering left-right process (well-behaved
    for EM: distinct per-state means, moderate variances)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    state_means = rng.normal(size=(S, D)) * 5.0
    utts = []
    for _ in range(B):
        bounds = np.sort(rng.choice(np.arange(1, T), S - 1, replace=False))
        ids = np.zeros(T, dtype=int)
        for k, b in enumerate(bounds):
            ids[b:] = k + 1
        utts.append(state_means[ids] + rng.normal(size=(T, D)))
    return utts


def bench_ours(utts) -> float:
    """Seconds per EM iteration (steady state), per OUR_B-utterance batch,
    on the production training path: em_train_scan — N iterations of
    E-step + M-step as ONE jitted lax.scan program."""
    import jax.numpy as jnp
    import numpy as np

    from srhmm_tpu.bench.suite import _timed
    from srhmm_tpu.init.lbg import create_initial_model
    from srhmm_tpu.io.dataset import pack_utterances
    from srhmm_tpu.train.em import em_train_scan

    model = create_initial_model([utts], S, [M], cov_type="diag").astype(
        jnp.float32
    )
    reps = -(-OUR_B // len(utts))
    batch = pack_utterances(
        (utts * reps)[:OUR_B], pad_multiple=128, dtype=jnp.float32
    )
    n_iter = 20
    run = lambda: em_train_scan(model, batch, n_iter)
    _, dt = _timed(run, 3)
    _, _, nvs = run()
    if not (np.asarray(nvs) == OUR_B).all():
        raise RuntimeError("invalid utterances in bench")
    return dt / n_iter


def bench_decode_rtf() -> float:
    """Continuous Viterbi decode RTF at reference scale: 13-word loop of
    6-state 1-mixture 9-dim models, block token passing, T=1000 frames."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from srhmm_tpu.decode.continuous import (
        compose_word_loop_blocks,
        composed_emissions,
        token_passing_blocks,
    )
    from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans, stack_models

    W, Sd, Dd, Td = 13, 6, 9, 1000
    rng = np.random.default_rng(1)

    def one(seed):
        r = np.random.default_rng(seed)
        means = r.normal(size=(Sd, 1, Dd)) * 4.0
        var = r.uniform(0.5, 1.5, size=(Sd, 1, Dd))
        return GmmHmm(
            trans=init_left_right_trans(Sd),
            streams=(
                GmmStream(
                    weights=jnp.ones((Sd, 1)),
                    means=jnp.asarray(means),
                    inv_cov=jnp.asarray(1.0 / var),
                    det=jnp.asarray(np.prod(var, -1)),
                    cov_type=DIAG,
                ),
            ),
            word=f"w{seed}",
        )

    vocab = stack_models([one(i) for i in range(W)]).astype(jnp.float32)
    graph = compose_word_loop_blocks(vocab)
    frames = jnp.asarray(rng.normal(size=(Td, Dd)), jnp.float32)

    from srhmm_tpu.bench.suite import _timed

    @jax.jit
    def decode(frames):
        log_b = composed_emissions(vocab, frames)
        final, bps = token_passing_blocks(graph, log_b, n_best=1)
        return final

    return _timed(lambda: decode(frames), 50)[1] / (Td * FRAME_SHIFT_S)


def bench_recognition(cov_type: str = "diag") -> float:
    """Batch isolated-word recognition throughput (audio-s scored per
    second): a 13-word reference-scale vocabulary, every utterance of a
    2048-utterance batch scored against every word (decode/scorer
    score_batch).  The C recognizer scores one
    utterance against the 13 models in 0.03 s (hmm-result.txt:182) = ~47
    audio-s/s.  cov_type="full" is the apples-to-apples workload: R1 (the
    program behind the golden report) scores FULL-covariance models
    (recognition-full-fs/recognition_continuous_full_fs.c:822-836)."""
    from srhmm_tpu.bench.suite import _timed, recognition_batch, recognition_vocab
    from srhmm_tpu.decode.scorer import score_batch

    vocab = recognition_vocab(cov_type)
    batch = recognition_batch()
    _, dt = _timed(lambda: score_batch(vocab, batch), 30)
    Br, Tr = batch.features.shape[:2]
    return Br * Tr * FRAME_SHIFT_S / dt


def bench_pipeline() -> dict:
    """The WHOLE framework as one system, with a quality axis: synthetic
    audio -> MFCC -> LBG -> monophone EM -> decision tree -> tied EM ->
    materialize -> bigram n_best=2 batched decode -> WER
    (srhmm_tpu/pipeline.py), at three SNR conditions.  Clean synthetic
    speech should sit near 0% WER; the SNR rows give the decode numbers an
    accuracy story.  Word count is FIXED per utterance so shape buckets
    collapse and the compile count stays bounded."""
    import dataclasses

    from srhmm_tpu.pipeline import PipelineConfig, run_pipeline

    out = {"metric": "pipeline_e2e"}
    base = PipelineConfig(min_words=3, max_words=3)
    t_all = time.perf_counter()
    for label, snr in (("clean", None), ("10db", 10.0), ("0db", 0.0)):
        cfg = dataclasses.replace(base, snr_db=snr)
        t0 = time.perf_counter()
        res = run_pipeline(
            cfg, n_train=40, n_test=16, max_iterations=5, tied_iterations=5,
            n_best=2, pad_multiple=128,
        )
        out[f"wer_{label}"] = res.wer.wer
        out[f"wall_s_{label}"] = time.perf_counter() - t0
    out["n_senones"] = res.n_senones
    out["n_units"] = res.n_units
    out["ref_words"] = res.wer.num_ref_words
    out["wall_s_total"] = time.perf_counter() - t_all
    return out


def bench_reference(utts) -> float | None:
    """Seconds per EM iteration of the reference C diag trainer; None if the
    reference isn't available.  Includes its per-iteration disk re-reads —
    that is how the reference works (T1:259/287)."""
    if CACHE.exists():
        try:
            return json.loads(CACHE.read_text())["ref_seconds_per_iter"]
        except Exception:
            pass
    if not REF_SRC.exists():
        return None
    import numpy as np

    work = pathlib.Path("/tmp/srhmm_bench_ref")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    exe = work / "hmm_fs"
    r = subprocess.run(
        ["gcc", "-O2", "-o", str(exe), str(REF_SRC), "-lm"],
        capture_output=True,
        text=True,
    )
    if r.returncode != 0:
        return None
    lines = []
    for i, u in enumerate(utts):
        p = work / f"u{i:03d}.perfil"
        with open(p, "wb") as f:
            f.write(struct.pack("<i", D))
            f.write(np.ascontiguousarray(u, dtype="<f8").tobytes())
        lines.append(str(p))
    (work / "list.txt").write_text("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [str(exe), "bench", str(S), "1", str(M), str(work / "list.txt"),
         str(work / "out.hmm")],
        capture_output=True,
        text=True,
        cwd=work,
        timeout=3600,
    )
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        return None
    txt = (work / "out.txt").read_text()
    iters = int(txt.split("number of iterations:")[1].split()[0])
    per_iter = wall / max(iters, 1)
    CACHE.write_text(
        json.dumps(
            {"ref_seconds_per_iter": per_iter, "wall": wall, "iterations": iters}
        )
    )
    return per_iter


def main():
    import jax

    from srhmm_tpu.bench import suite
    from srhmm_tpu.ops.backend import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {jax.devices()}")
    enable_compile_cache()
    dev = suite.device_row()
    utts = make_dataset()

    def emit(row):
        print(json.dumps({**row, **dev}), flush=True)

    import numpy as np

    rng = np.random.default_rng(0)
    for c in (1, 2, 3, 4, 5):
        emit(suite.CONFIGS[c](rng))
    pipe = bench_pipeline()
    emit(pipe)
    for ct in ("diag", "full"):
        rec = bench_recognition(ct)
        emit({"metric": f"batch_recognition_{ct}_audio_s_per_sec",
              "value": rec, "unit": "audio_s/s",
              # C: 13-model score+rank in 0.03 s per 1.42 s utterance
              "vs_baseline": rec / (1.42 / 0.03)})
    rtf = bench_decode_rtf()
    emit({"metric": "decode_rtf", "value": rtf, "unit": "rtf",
          "vs_baseline": BASELINE_DECODE_RTF / rtf})

    ours = bench_ours(utts)
    ref = bench_reference(utts)
    ours_rate = OUR_B * T * FRAME_SHIFT_S / ours
    emit({
        "metric": "em_train_audio_seconds_per_sec",
        "value": ours_rate,
        "unit": "audio_s/s",
        "vs_baseline": ours_rate / (AUDIO_SECONDS / ref) if ref else None,
        "decode_rtf": rtf,
        "pipeline_wer_clean": pipe["wer_clean"],
        "pipeline_wer_0db": pipe["wer_0db"],
    })


if __name__ == "__main__":
    main()
