"""The Triton-route lattice kernels (ops/lattice_triton.py) in the Pallas
interpreter against the plain lax.scan recursions, and the E-step and
scorer built on them against their XLA forms (srhmm_tpu.checks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu.models import DIAG, FULL, GmmHmm, GmmStream, init_left_right_trans, stack_models
from srhmm_tpu.ops.forward_backward import log_backward_full, log_forward_full
from srhmm_tpu.ops.lattice_triton import backward_lattice, forward_lattice


def _log_trans(S, band):
    """Left-right (band = 1) or a dense ergodic matrix (band None)."""
    if band is None:
        t = np.random.default_rng(S).uniform(0.1, 1.0, size=(S, S))
        t /= t.sum(-1, keepdims=True)
    else:
        t = np.asarray(init_left_right_trans(S, delta=band))
    with np.errstate(divide="ignore"):
        return jnp.asarray(np.log(t), jnp.float32)


def _scan_lattices(log_b_bts, log_trans, lengths):
    la = jax.vmap(log_forward_full, (0, None, 0))(log_b_bts, log_trans, lengths)
    lbw = jax.vmap(log_backward_full, (0, None, 0))(log_b_bts, log_trans, lengths)
    tsb = lambda a: np.transpose(np.asarray(a), (1, 2, 0))
    return tsb(la), tsb(lbw)


def _assert_lattice_equal(got, ref):
    got = np.asarray(got)
    fin = np.isfinite(ref)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("band", [1, None])
@pytest.mark.parametrize("S,B,T", [(6, 37, 23), (8, 64, 40), (3, 5, 7), (5, 130, 17)])
def test_forward_backward_match_scan(S, B, T, band):
    """Odd state counts (padded to a power of two), odd batch sizes
    (padded to the lane block), ragged lengths, banded and dense
    transitions: both kernels reproduce the lax.scan lattices."""
    rng = np.random.default_rng(S * 1000 + B + T)
    lt = _log_trans(S, band)
    lb = jnp.asarray(rng.normal(size=(B, T, S)) * 3.0, jnp.float32)
    lengths = jnp.asarray(rng.integers(1, T + 1, size=B), jnp.int32)
    ref_a, ref_b = _scan_lattices(lb, lt, lengths)
    lb_tsb = jnp.transpose(lb, (1, 2, 0))
    _assert_lattice_equal(forward_lattice(lb_tsb, lt, lengths, interpret=True), ref_a)
    _assert_lattice_equal(backward_lattice(lb_tsb, lt, lengths, interpret=True), ref_b)


@pytest.mark.parametrize("block_lanes", [16, 64])
def test_forward_final_only_is_last_valid_row(block_lanes):
    """final_only returns each lane's last valid log-alpha row."""
    rng = np.random.default_rng(block_lanes)
    S, B, T = 5, 40, 19
    lt = _log_trans(S, 1)
    lb = jnp.asarray(rng.normal(size=(T, S, B)), jnp.float32)
    lengths = jnp.asarray(rng.integers(1, T + 1, size=B), jnp.int32)
    full = np.asarray(forward_lattice(lb, lt, lengths, interpret=True))
    fin = np.asarray(
        forward_lattice(
            lb, lt, lengths, final_only=True, block_lanes=block_lanes,
            interpret=True,
        )
    )
    np.testing.assert_array_equal(fin, full[-1])


def test_per_lane_transitions_and_empty_lanes():
    """(S, S, N) per-lane transitions: each lane follows its own matrix;
    zero-length lanes keep the initialization."""
    rng = np.random.default_rng(0)
    S, N, T = 4, 9, 12
    mats = [_log_trans(S, 1), _log_trans(S, None), _log_trans(S, 2)]
    which = rng.integers(0, 3, size=N)
    lt = jnp.stack([mats[i] for i in which], axis=-1)  # (S, S, N)
    lb = jnp.asarray(rng.normal(size=(T, S, N)), jnp.float32)
    lengths = jnp.asarray(rng.integers(0, T + 1, size=N), jnp.int32)
    got = np.asarray(forward_lattice(lb, lt, lengths, interpret=True))
    for n in range(N):
        ref = np.asarray(log_forward_full(lb[:, :, n], mats[which[n]], lengths[n]))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[:, :, n][fin], ref[fin], rtol=1e-6, atol=1e-5)
        assert (np.isfinite(got[:, :, n]) == fin).all()


def _model(cov, S=5, M=2, D=4, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * 2.0
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    if cov == FULL:
        a = rng.normal(size=(S, M, D, D)) * 0.3
        c = a @ np.swapaxes(a, -1, -2) + np.eye(D)[None, None]
        ic, det = np.linalg.inv(c), np.linalg.det(c)
    else:
        v = rng.uniform(0.5, 1.5, size=(S, M, D))
        ic, det = 1.0 / v, np.prod(v, -1)
    return GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w), means=jnp.asarray(means),
                inv_cov=jnp.asarray(ic), det=jnp.asarray(det), cov_type=cov,
            ),
        ),
        word=f"w{seed}",
    ).astype(jnp.float32)


@pytest.mark.parametrize("cov", [DIAG, FULL])
def test_e_step_on_kernels_matches_xla(cov):
    """srhmm_tpu.checks.compare_e_step (the check chip_smoke.py runs on the
    card) passes in the interpreter: log Z and every statistic within the
    stated tolerances, odd batch and ragged lengths."""
    from srhmm_tpu.checks import compare_e_step

    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(20 + 7 * i, 4)) * 2.0 for i in range(7)]
    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)
    out = compare_e_step(_model(cov), batch, interpret=True)
    assert out["ok"], out


@pytest.mark.parametrize("mode", ["total", "final"])
@pytest.mark.parametrize("cov", [DIAG, FULL])
def test_scores_on_kernel_match_xla(cov, mode):
    """srhmm_tpu.checks.compare_scores in the interpreter: the kernel
    scorer's (B, W) scores and rankings equal score_batch_log's."""
    from srhmm_tpu.checks import compare_scores

    vocab = stack_models([_model(cov, seed=s) for s in range(4)])
    rng = np.random.default_rng(9)
    batch = pack_utterances(
        [rng.normal(size=(15 + 4 * i, 4)) * 2.0 for i in range(6)],
        pad_multiple=8, dtype=jnp.float32,
    )
    out = compare_scores(vocab, batch, mode=mode, interpret=True)
    assert out["ok"], out
