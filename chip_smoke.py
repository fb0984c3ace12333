#!/usr/bin/env python3
"""Smoke run of the recognizer on one GPU, through its own entry points.

    python chip_smoke.py             # every phase, one card
    python chip_smoke.py --cards 4   # only the multi-device paths, 4 cards

One process holds the card for every phase.  Each phase prints its set-up
(first call, compilation included) and run seconds and every compared
number beside its limit; the script exits non-zero on any failed phase.
Its last line is one JSON object naming the device:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU it prints no result and exits 2.

Phases (one card), all at real widths on data made from --seed:
  1. isolated EM: train_fast at S=8, M=3, D=9, B=2048, T=512, 3 iterations;
     one E-step on the Triton lattices vs the XLA scans;
  2. batch recognition: score_batch at W=13, B=2048, T=500, diagonal and
     full covariance, vs score_batch_log;
  3. tied-state training, config 5 (2000 senones x 16 mixtures, D=39,
     700 units, B=1024, T=304): train_tied for 2 iterations; one E-step on
     a 64-utterance slice vs the host CPU backend;
  4. batched continuous decode: W=200, S=8, M=4, D=13, T=1000, B=128,
     bigram LM, n_best 1 and 2, vs the per-utterance engine;
  5. the whole system: srhmm_tpu.cli.pipeline at its defaults, clean and
     --snr 10; WER <= 0.10 and within 0.02 of the same run on the host CPU.

With --cards 4 (a flat `data` mesh): train_fast(data_mesh) vs one card,
run_pipeline(mesh) vs one card, and time-sharded EM vs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time

WER_MAX = 0.10
WER_CPU_GAP = 0.02
HISTORY_RTOL = 1e-5
PIPELINE_LP_RTOL = 1e-4


def _print(*a):
    print(*a, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _setup_and_run(name, fn):
    """Call fn twice: the first call (compilation included) is set-up, the
    second is the run."""
    _, setup = _timed(fn)
    out, run = _timed(fn)
    _print(f"[{name}] setup {setup:.3f} s, run {run:.3f} s")
    return out


def _report(name, result: dict) -> bool:
    nums = ", ".join(
        f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()
    )
    _print(f"[{name}] {nums}")
    return bool(result["ok"])


def _isolated_data(seed, B=2048, T=512, S=8, M=3, D=9):
    import jax.numpy as jnp
    import numpy as np

    from srhmm_tpu.bench.suite import _rand_model
    from srhmm_tpu.io.dataset import UtteranceBatch

    rng = np.random.default_rng(seed)
    model = _rand_model(rng, S, M, D, jnp.float32)
    # left-right segment labels: S-1 sorted cut points per utterance
    cuts = np.sort(rng.random((B, S - 1)), axis=1) * T
    state = (np.arange(T)[None, :, None] >= cuts[:, None, :]).sum(-1)
    means = np.asarray(model.streams[0].means)[:, 0]  # (S, D)
    feats = means[state] + rng.normal(size=(B, T, D))
    lengths = rng.integers(T // 2, T + 1, size=B)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    batch = UtteranceBatch(
        features=jnp.asarray(feats, jnp.float32),
        lengths=jnp.asarray(lengths, jnp.int32),
    )
    return model, batch


def phase_isolated_em(seed) -> bool:
    from srhmm_tpu.checks import compare_e_step
    from srhmm_tpu.train.em import train_fast

    model, batch = _isolated_data(seed)
    _setup_and_run(
        "1 isolated EM",
        lambda: train_fast(model, batch, threshold=0.0, max_iterations=3).model,
    )
    out = compare_e_step(model, batch)
    return _report("1 E-step triton vs xla", out)


def phase_recognition(seed) -> bool:
    from srhmm_tpu.bench.suite import recognition_batch, recognition_vocab
    from srhmm_tpu.checks import compare_scores
    from srhmm_tpu.decode.scorer import score_batch

    ok = True
    batch = recognition_batch(seed=seed)
    for cov in ("diag", "full"):
        vocab = recognition_vocab(cov)
        _setup_and_run(f"2 score_batch {cov}", lambda: score_batch(vocab, batch))
        for mode in ("total", "final"):
            ok &= _report(
                f"2 scores {cov} {mode} triton vs xla",
                compare_scores(vocab, batch, mode=mode),
            )
    return ok


def phase_tied(seed) -> bool:
    import jax
    import numpy as np

    from srhmm_tpu.bench.suite import config5_data
    from srhmm_tpu.checks import compare_on_cpu
    from srhmm_tpu.train.tied import tied_batch_stats, train_tied

    tied, transcripts, feats, lengths = config5_data(np.random.default_rng(seed))
    f_np, l_np, t_np = np.asarray(feats), np.asarray(lengths), np.asarray(transcripts)
    utts = [f_np[i, : l_np[i]] for i in range(len(l_np))]
    trs = [list(t_np[i]) for i in range(len(l_np))]
    _setup_and_run(
        "3 train_tied config 5",
        lambda: train_tied(
            tied, utts, trs, threshold=0.0, max_iterations=2, chunk=2,
            pad_multiple=16,
        ).model,
    )
    n = 64
    stats = jax.jit(tied_batch_stats)
    args = (tied, transcripts[:n], feats[:n], lengths[:n])
    log_z = abs(float(stats(*args)[4])) / n  # per-utterance |log Z|
    out = compare_on_cpu(stats, *args, log_z_scale=log_z)
    out["log_z_per_utt"] = log_z
    return _report("3 tied E-step gpu vs cpu", out)


def _decode_data(seed, W=200, S=8, M=4, D=13, T=1000, B=128):
    """A W-word vocabulary and B utterances drawn from it: each word
    contributes a run of frames near its states' first-mixture means."""
    import jax.numpy as jnp
    import numpy as np

    from srhmm_tpu.bench.suite import _vocab
    from srhmm_tpu.io.dataset import UtteranceBatch

    rng = np.random.default_rng(seed)
    vocab = _vocab(rng, W, S, M, D)
    means = np.asarray(vocab.streams[0].means)[:, :, 0]  # (W, S, D)
    feats = np.zeros((B, T, D), np.float32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        frames = []
        n = 0
        while True:
            w = rng.integers(W)
            dur = rng.integers(8, 14, size=S)
            if n + dur.sum() > T:
                break
            frames.append(np.repeat(means[w], dur, axis=0))
            n += dur.sum()
        x = np.concatenate(frames) + 0.5 * rng.normal(size=(n, D))
        feats[b, :n] = x
        lengths[b] = n
    lm = np.log(rng.dirichlet(np.ones(W), size=W))
    batch = UtteranceBatch(
        features=jnp.asarray(feats), lengths=jnp.asarray(lengths)
    )
    return vocab, batch, lm


def phase_decode(seed) -> bool:
    from srhmm_tpu.checks import compare_batched_decode
    from srhmm_tpu.decode.continuous import decode_continuous_batch

    vocab, batch, lm = _decode_data(seed)
    ok = True
    for k in (1, 2):
        _setup_and_run(
            f"4 decode_continuous_batch n_best={k}",
            lambda: decode_continuous_batch(vocab, batch, lm_logprobs=lm, n_best=k),
        )
        ok &= _report(
            f"4 batched vs per-utterance n_best={k}",
            compare_batched_decode(
                vocab, batch, [0, 1, 2], n_best=k, lm_logprobs=lm
            ),
        )
    return ok


def _pipeline_cli(args) -> dict:
    """srhmm_tpu.cli.pipeline.main in this process; its JSON summary."""
    from srhmm_tpu.cli import pipeline as cli_pipeline

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_pipeline.main(list(args) + ["--quiet"])
    if rc != 0:
        raise RuntimeError(f"cli.pipeline {args} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_pipeline(seed) -> bool:
    import jax

    ok = True
    for snr in (None, 10.0):
        args = ["--seed", str(seed)] + ([] if snr is None else ["--snr", str(snr)])
        t0 = time.perf_counter()
        gpu = _pipeline_cli(args)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        gpu = _pipeline_cli(args)
        run = time.perf_counter() - t0
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = _pipeline_cli(args)
        label = "clean" if snr is None else f"{snr:g} dB"
        _print(f"[5 pipeline {label}] setup {setup:.3f} s, run {run:.3f} s")
        _print(f"[5 pipeline {label}] stage seconds {json.dumps(gpu['stage_seconds'])}")
        ok &= _report(
            f"5 pipeline {label}",
            {
                "wer": gpu["wer"], "wer_limit": WER_MAX,
                "wer_cpu": cpu["wer"], "gap_limit": WER_CPU_GAP,
                "ok": gpu["wer"] <= WER_MAX
                and abs(gpu["wer"] - cpu["wer"]) <= WER_CPU_GAP,
            },
        )
    return ok


def _rel_hist(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def phase_multi_card(seed, n_cards) -> bool:
    import jax
    import numpy as np

    from srhmm_tpu.parallel.mesh import make_mesh
    from srhmm_tpu.pipeline import PipelineConfig, run_pipeline
    from srhmm_tpu.train.em import em_train_scan, em_train_scan_time_sharded, train_fast

    devs = jax.devices()[:n_cards]
    data_mesh = make_mesh(n_data=n_cards, n_model=1, devices=devs)
    time_mesh = jax.sharding.Mesh(np.asarray(devs), ("time",))
    model, batch = _isolated_data(seed)
    ok = True

    run1 = lambda: train_fast(model, batch, threshold=0.0, max_iterations=3)
    runn = lambda: train_fast(
        model, batch, threshold=0.0, max_iterations=3, data_mesh=data_mesh
    )
    _setup_and_run("M1 train_fast 1 card", lambda: run1().model)
    _setup_and_run(f"M1 train_fast data_mesh {n_cards} cards", lambda: runn().model)
    h1, hn = run1().log_prob_history, runn().log_prob_history
    ok &= _report(
        f"M1 data-parallel {n_cards} vs 1",
        {"history_rel": _rel_hist(hn, h1), "limit": HISTORY_RTOL,
         "ok": _rel_hist(hn, h1) <= HISTORY_RTOL},
    )

    ref = lambda: em_train_scan(model, batch, 3, lattice="xla")
    ts = lambda: em_train_scan_time_sharded(model, batch, 3, time_mesh)
    _, lp1, _ = _setup_and_run("M2 em_train_scan 1 card (xla)", ref)
    _, lpn, _ = _setup_and_run(f"M2 time-sharded {n_cards} cards", ts)
    ok &= _report(
        f"M2 time-sharded {n_cards} vs 1",
        {"history_rel": _rel_hist(lpn, lp1), "limit": HISTORY_RTOL,
         "ok": _rel_hist(lpn, lp1) <= HISTORY_RTOL},
    )

    cfg = PipelineConfig(seed=seed)
    t0 = time.perf_counter()
    p1 = run_pipeline(cfg)
    t1 = time.perf_counter()
    pn = run_pipeline(cfg, mesh=data_mesh)
    t2 = time.perf_counter()
    _print(f"[M3 pipeline] 1 card {t1 - t0:.3f} s, {n_cards} cards {t2 - t1:.3f} s")
    mono = _rel_hist(pn.mono_log_prob, p1.mono_log_prob)
    tied = _rel_hist(pn.tied_log_prob, p1.tied_log_prob)
    ok &= _report(
        f"M3 pipeline mesh {n_cards} vs 1",
        {"wer": pn.wer.wer, "wer_1card": p1.wer.wer,
         "mono_lp_rel": mono, "tied_lp_rel": tied, "limit": PIPELINE_LP_RTOL,
         "ok": pn.wer.wer == p1.wer.wer and mono <= PIPELINE_LP_RTOL
         and tied <= PIPELINE_LP_RTOL},
    )
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ns = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < ns.cards:
        print(f"--cards {ns.cards}: only {len(jax.devices())} devices",
              file=sys.stderr)
        return 2

    from srhmm_tpu.ops.backend import enable_compile_cache

    _print(_card_line())
    _print(f"jax {jax.__version__}; compile cache {enable_compile_cache()}")
    if ns.cards > 1:
        phases = [("multi-card", lambda s: phase_multi_card(s, ns.cards))]
    else:
        phases = [
            ("isolated EM", phase_isolated_em),
            ("recognition", phase_recognition),
            ("tied config 5", phase_tied),
            ("batched decode", phase_decode),
            ("pipeline", phase_pipeline),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        if not fn(ns.seed):
            failed.append(name)
        _print(f"== {name}: {time.perf_counter() - t0:.3f} s")
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    _print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
