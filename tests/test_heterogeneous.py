"""Heterogeneous-vocabulary support: mixed (S, M) model shapes in one
recognition run, matching the reference's linked-list loader capability
(recognition-fs/recognition_continuous_fs.c:201-245 reads per-model
states_number/mixture_number), plus model-set ensembling
(coef_model-weighted log-linear combination, R2:193-196, 326-370).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.decode.scorer import score_vocab_log, score_vocab_parity
from srhmm_tpu.io import write_hmm
from srhmm_tpu.models import (
    DIAG,
    FULL,
    GmmHmm,
    GmmStream,
    init_left_right_trans,
    pad_stack_models,
    stack_models,
)

REPO = Path(__file__).resolve().parent.parent


def _model(S, M, D=6, seed=0, cov_type=DIAG, word="w"):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * 2.0
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    if cov_type == FULL:
        inv_cov = np.zeros((S, M, D, D))
        for s in range(S):
            for m in range(M):
                inv_cov[s, m] = np.diag(1.0 / var[s, m])
        det = np.prod(var, -1)
    else:
        inv_cov = 1.0 / var
        det = np.prod(var, -1)
    return GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w),
                means=jnp.asarray(means),
                inv_cov=jnp.asarray(inv_cov),
                det=jnp.asarray(det),
                cov_type=cov_type,
            ),
        ),
        word=word,
    )


MIXED = [(5, 1), (8, 3), (6, 2), (3, 4)]


@pytest.mark.parametrize("mode", ["total", "final"])
@pytest.mark.parametrize("cov_type", [DIAG, FULL])
def test_padded_stack_scores_match_individual(mode, cov_type):
    """Padded heterogeneous scoring == scoring each model on its own."""
    models = [
        _model(S, M, seed=i, cov_type=cov_type, word=f"w{i}")
        for i, (S, M) in enumerate(MIXED)
    ]
    rng = np.random.default_rng(42)
    frames = jnp.asarray(rng.normal(size=(40, 6)))

    stacked, final_states = pad_stack_models(models)
    got = np.asarray(
        score_vocab_log(stacked, (frames,), mode=mode, final_states=final_states)
    )
    want = np.asarray(
        [
            score_vocab_log(stack_models([m]), (frames,), mode=mode)[0]
            for m in models
        ]
    )
    np.testing.assert_allclose(got, want, rtol=1e-6)

    got_p = np.asarray(
        score_vocab_parity(
            stacked, (frames,), mode=mode, final_states=final_states
        )
    )
    want_p = np.asarray(
        [
            score_vocab_parity(stack_models([m]), (frames,), mode=mode)[0]
            for m in models
        ]
    )
    np.testing.assert_allclose(got_p, want_p, rtol=1e-10)


def test_pad_stack_rejects_dim_mismatch():
    a, b = _model(4, 2, D=6), _model(4, 2, D=7)
    with pytest.raises(ValueError, match="feature dims differ"):
        pad_stack_models([a, b])


def _run_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "srhmm_tpu.cli.recognize", *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )


def _write_perfil(path, frames):
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack("<i", frames.shape[1]))
        f.write(np.ascontiguousarray(frames, dtype="<f8").tobytes())


def test_recognize_cli_mixed_shapes(tmp_path):
    """The recognize CLI accepts a mixed 5-state/8-state vocabulary (the C
    linked-list loader does, R2:201-245) and its scores match per-model
    individual scoring."""
    models = [
        _model(S, M, seed=i, cov_type=DIAG, word=f"w{i}")
        for i, (S, M) in enumerate(MIXED)
    ]
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(30, 6))

    paths = []
    for m in models:
        p = tmp_path / f"{m.word}.hmm"
        write_hmm(p, m)
        paths.append(p)
    (tmp_path / "models.txt").write_text("\n".join(str(p) for p in paths) + "\n")
    _write_perfil(tmp_path / "utt.perfil", frames)
    (tmp_path / "inputs.txt").write_text(str(tmp_path / "utt.perfil") + "\n")
    (tmp_path / "words.txt").write_text("w1\n")

    r = _run_cli(
        [
            "--mode", "final",
            "1", str(tmp_path / "models.txt"), "1",
            str(tmp_path / "inputs.txt"),
            str(tmp_path / "words.txt"),
            str(tmp_path / "out.txt"),
        ],
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr

    # parse the per-word scores from stdout ("word :  score")
    got = {}
    for line in r.stdout.splitlines():
        parts = line.split(":")
        if len(parts) == 2 and parts[0].strip().startswith("w"):
            got[parts[0].strip()] = float(parts[1])
    want = {
        m.word: float(
            score_vocab_parity(
                stack_models([m]), (jnp.asarray(frames),), mode="final"
            )[0]
        )
        for m in models
    }
    assert set(got) == set(want)
    for w in want:
        np.testing.assert_allclose(got[w], want[w], rtol=1e-6)


def test_recognize_cli_model_set_ensembling(tmp_path):
    """models_number=2 with distinct coef_model weights: the combined score
    must equal coefA * scoreA + coefB * scoreB (R2:326-370), where each set
    scores its own input stream."""
    words = ["w0", "w1", "w2"]
    set_a = [_model(5, 2, seed=10 + i, word=w) for i, w in enumerate(words)]
    set_b = [_model(5, 2, seed=20 + i, word=w) for i, w in enumerate(words)]
    rng = np.random.default_rng(3)
    frames_a = rng.normal(size=(25, 6))
    frames_b = rng.normal(size=(31, 6))

    for tag, ms in (("a", set_a), ("b", set_b)):
        lines = []
        for m in ms:
            p = tmp_path / f"{tag}_{m.word}.hmm"
            write_hmm(p, m)
            lines.append(str(p))
        (tmp_path / f"models_{tag}.txt").write_text("\n".join(lines) + "\n")
    _write_perfil(tmp_path / "utt_a.perfil", frames_a)
    _write_perfil(tmp_path / "utt_b.perfil", frames_b)
    (tmp_path / "inputs_a.txt").write_text(str(tmp_path / "utt_a.perfil") + "\n")
    (tmp_path / "inputs_b.txt").write_text(str(tmp_path / "utt_b.perfil") + "\n")
    (tmp_path / "words.txt").write_text("w1\n")

    coef_a, coef_b = 0.7, 0.3
    r = _run_cli(
        [
            "--mode", "final",
            "2",
            str(tmp_path / "models_a.txt"), str(tmp_path / "models_b.txt"),
            str(coef_a), str(coef_b),
            str(tmp_path / "inputs_a.txt"), str(tmp_path / "inputs_b.txt"),
            str(tmp_path / "words.txt"),
            str(tmp_path / "out.txt"),
        ],
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr

    got = {}
    for line in r.stdout.splitlines():
        parts = line.split(":")
        if len(parts) == 2 and parts[0].strip() in words:
            got[parts[0].strip()] = float(parts[1])

    sa = np.asarray(
        score_vocab_parity(stack_models(set_a), (jnp.asarray(frames_a),), mode="final")
    )
    sb = np.asarray(
        score_vocab_parity(stack_models(set_b), (jnp.asarray(frames_b),), mode="final")
    )
    want = coef_a * sa + coef_b * sb
    assert set(got) == set(words)
    for i, w in enumerate(words):
        np.testing.assert_allclose(got[w], want[i], rtol=1e-6)
    # and the report ranks by the combined score
    order = [words[i] for i in np.argsort(-want)]
    out_lines = [l for l in r.stdout.splitlines() if ":" in l and l.split(":")[0].strip() in words]
    assert [l.split(":")[0].strip() for l in out_lines[: len(words)]] == order


@pytest.mark.parametrize("mode", ["total", "final"])
def test_fused_scorer_heterogeneous_matches_xla(mode):
    """HETEROGENEOUS padded vocabularies on the lattice-kernel scorer
    (score_batch_lattice, Pallas interpreter on CPU): filler states are
    unreachable and final-state scoring gathers the per-word final_states
    indices — must reproduce score_batch_log on the same padded stack
    (srhmm_tpu.checks.compare_scores: scores and rankings)."""
    from srhmm_tpu.checks import compare_scores
    from srhmm_tpu.io.dataset import pack_utterances

    models = [
        _model(4, 2, seed=1, word="a"),
        _model(6, 1, seed=2, word="b"),
        _model(3, 3, seed=3, word="c"),
        _model(5, 2, seed=4, word="d"),
    ]
    stacked, final_states = pad_stack_models(models)
    stacked = stacked.astype(jnp.float32)
    rng = np.random.default_rng(0)
    batch = pack_utterances(
        [rng.normal(size=(40 + 7 * i, 6)) for i in range(5)],
        pad_multiple=16,
        dtype=jnp.float32,
    )
    out = compare_scores(
        stacked, batch, mode=mode, final_states=final_states, interpret=True
    )
    assert out["ok"], out
