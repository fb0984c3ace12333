"""Data/model-parallel EM on the virtual 8-device CPU mesh: sharded results
must equal single-device results (SURVEY §4: multi-host tests via
xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans
from srhmm_tpu.parallel import make_mesh, replicate, shard_batch, shard_model
from srhmm_tpu.train.em import em_step


def _toy(S=4, M=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * 2.0
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    model = GmmHmm(
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
    )
    utts = [rng.normal(size=(50 + 3 * i, D)) for i in range(16)]
    batch = pack_utterances(utts, pad_multiple=16, dtype=jnp.float64)
    return model, batch


def _assert_model_close(a: GmmHmm, b: GmmHmm, rtol=1e-9):
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_em_matches_single_device(shape):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    model, batch = _toy()
    ref_model, ref_lp, ref_nv = em_step(model, batch)

    mesh = make_mesh(n_data=shape[0], n_model=shape[1])
    sh_model = shard_model(model, mesh)
    sh_batch = shard_batch(batch, mesh)
    got_model, got_lp, got_nv = em_step(sh_model, sh_batch)

    np.testing.assert_allclose(float(got_lp), float(ref_lp), rtol=1e-12)
    assert float(got_nv) == float(ref_nv)
    _assert_model_close(got_model, ref_model)


def test_sharded_scoring_matches():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from srhmm_tpu.decode.scorer import score_batch_log
    from srhmm_tpu.models import stack_models

    model, batch = _toy()
    vocab = stack_models([model.replace(word=f"w{i}") for i in range(8)])
    ref = np.asarray(score_batch_log(vocab, batch))

    mesh = make_mesh(n_data=8, n_model=1)
    sh_batch = shard_batch(batch, mesh)
    sh_vocab = replicate(vocab, mesh)
    got = np.asarray(score_batch_log(sh_vocab, sh_batch))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_fused_lane_sharded_matches_single_device():
    """The explicit shard_map + psum composition of the production E-step
    (the form a pallas_call lattice needs: GSPMD cannot partition it) must
    match the unsharded e_step."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from srhmm_tpu.train.em import e_step, e_step_sharded

    model, batch = _toy()
    model = model.astype(jnp.float32)
    batch = batch.replace(features=batch.features.astype(jnp.float32))
    mesh = make_mesh(n_data=8, n_model=1)
    ref = e_step(model, batch)
    got = e_step_sharded(model, batch, mesh)
    for name in ["num_trans", "den_trans", "den_mix", "log_prob", "num_valid"]:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        np.testing.assert_allclose(
            b, a, rtol=2e-3, atol=2e-4 * max(np.abs(a).max(), 1.0)
        )
    for name in ["w", "x", "xx"]:
        a = np.asarray(getattr(ref.streams[0], name))
        b = np.asarray(getattr(got.streams[0], name))
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4 * np.abs(a).max())


def test_sharded_scan_trajectory_matches_per_step():
    """em_train_scan_sharded (the WHOLE N-iteration scan inside one
    shard_map, psum in the scan body) must reproduce the per-step
    e_step_sharded + m_step loop's trajectory."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from srhmm_tpu.train.em import (
        e_step_sharded,
        em_train_scan_sharded,
        m_step,
        _with_log_det,
    )

    model, batch = _toy()
    model = _with_log_det(model.astype(jnp.float32))
    batch = batch.replace(features=batch.features.astype(jnp.float32))
    mesh = make_mesh(n_data=8, n_model=1)
    n_iters = 4

    final, lps, nvs = em_train_scan_sharded(model, batch, n_iters, mesh)

    cur = model
    ref_lps = []
    for _ in range(n_iters):
        st = e_step_sharded(cur, batch, mesh)
        ref_lps.append(float(st.log_prob))
        cur = m_step(cur, st)

    np.testing.assert_allclose(np.asarray(lps), np.asarray(ref_lps), rtol=1e-6)
    assert np.all(np.asarray(nvs) == batch.batch_size)
    # f32 accumulation order differs between the scanned and per-step
    # shard_map programs and compounds over the 4 chained M-steps;
    # parameters agree to accumulated f32 roundoff (the per-iteration
    # log-prob check above is the exact-trajectory assertion)
    for la, lb in zip(jax.tree.leaves(final), jax.tree.leaves(cur)):
        a = np.asarray(la)
        np.testing.assert_allclose(
            np.asarray(lb), a, rtol=1e-3, atol=1e-3 * max(1.0, np.abs(a).max())
        )


def test_fused_composed_sharded_matches_single_device():
    """Data-parallel composed E-steps (embedded AND tied): explicit
    shard_map + psum of the per-shard statistics must match the unsharded
    statistics — the all-reduce shape of BASELINE config 5."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from srhmm_tpu.models import stack_models
    from srhmm_tpu.models.tying import tie_from_models
    from srhmm_tpu.train.embedded import batch_stats, batch_stats_sharded
    from srhmm_tpu.train.tied import tied_batch_stats, tied_batch_stats_sharded

    rng = np.random.default_rng(0)
    P, S, M, D, B, T, L = 4, 3, 2, 5, 8, 24, 3

    def unit(seed):
        r = np.random.default_rng(seed)
        means = r.normal(size=(S, M, D)) * 3.0
        var = r.uniform(0.5, 1.5, size=(S, M, D))
        w = r.uniform(0.3, 0.7, size=(S, M))
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
            word=f"u{seed}",
        )

    models = stack_models([unit(i) for i in range(P)]).astype(jnp.float32)
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0, jnp.float32)
    lengths = jnp.asarray([T, T - 3, T, 9, T, T - 1, T, T - 5], jnp.int32)
    mesh = make_mesh(n_data=8, n_model=1)

    ref = batch_stats(models, transcripts, feats, lengths)
    got = batch_stats_sharded(models, transcripts, feats, lengths, mesh)
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        a = np.asarray(r)
        np.testing.assert_allclose(
            np.asarray(g), a, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(a).max())
        )

    N = 6
    sm = rng.integers(0, N, size=(P, S)).astype(np.int32)
    sm[0] = [0, 1, 2]
    tied = tie_from_models(models, sm).astype(jnp.float32)
    tref = tied_batch_stats(tied, transcripts, feats, lengths)
    tgot = tied_batch_stats_sharded(tied, transcripts, feats, lengths, mesh)
    for r, g in zip(jax.tree.leaves(tref), jax.tree.leaves(tgot)):
        a = np.asarray(r)
        np.testing.assert_allclose(
            np.asarray(g), a, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(a).max())
        )


def test_composed_sharded_scan_trajectory_matches_single_device():
    """Multi-device COMPOSED training: embedded_train_scan_sharded /
    tied_train_scan_sharded put the whole N-iteration scan inside one
    shard_map (per-shard statistics, unit/senone psum in the scan body,
    replicated update as the carry) —
    trajectories must equal the single-device _embedded_chunk /
    _tied_chunk scans; final parameters within reduction-order
    rounding."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from srhmm_tpu.models import stack_models
    from srhmm_tpu.models.tying import tie_from_models
    from srhmm_tpu.train.embedded import (
        _embedded_chunk,
        embedded_train_scan_sharded,
    )
    from srhmm_tpu.train.tied import _tied_chunk, tied_train_scan_sharded

    rng = np.random.default_rng(5)
    P, S, M, D, B, T, L = 3, 3, 2, 5, 8, 32, 2

    def unit(seed):
        r = np.random.default_rng(seed)
        means = r.normal(size=(S, M, D)) * 3.0
        var = r.uniform(0.5, 1.5, size=(S, M, D))
        return GmmHmm(
            trans=init_left_right_trans(S),
            streams=(
                GmmStream(
                    weights=jnp.ones((S, M)) / M,
                    means=jnp.asarray(means),
                    inv_cov=jnp.asarray(1.0 / var),
                    det=jnp.asarray(np.prod(var, -1)),
                    cov_type=DIAG,
                ),
            ),
            word=f"u{seed}",
        )

    models = stack_models([unit(i) for i in range(P)]).astype(jnp.float32)
    trs = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lens = jnp.asarray(rng.integers(T // 2, T + 1, size=(B,)), jnp.int32)
    packed = ((trs, feats, lens),)
    mesh = make_mesh(n_data=8, n_model=1)

    ref_final, ref_lps, _ = _embedded_chunk(models, packed, 3, 0.0)
    got_final, got_lps, _ = embedded_train_scan_sharded(
        models, packed, 3, mesh
    )
    np.testing.assert_allclose(
        np.asarray(got_lps), np.asarray(ref_lps), rtol=1e-5
    )
    for a, b in zip(jax.tree.leaves(got_final), jax.tree.leaves(ref_final)):
        if hasattr(a, "shape"):
            np.testing.assert_allclose(
                np.asarray(a, np.float64), np.asarray(b, np.float64),
                rtol=2e-3, atol=1e-4,
            )

    N = 5
    sm = rng.integers(0, N, size=(P, S)).astype(np.int32)
    sm[0] = [0, 1, 2]
    tied = tie_from_models(models, sm).astype(jnp.float32)
    tref_final, tref_lps, _ = _tied_chunk(tied, packed, 3, 0.0)
    tgot_final, tgot_lps, _ = tied_train_scan_sharded(tied, packed, 3, mesh)
    np.testing.assert_allclose(
        np.asarray(tgot_lps), np.asarray(tref_lps), rtol=1e-5
    )
    for a, b in zip(jax.tree.leaves(tgot_final), jax.tree.leaves(tref_final)):
        if hasattr(a, "shape"):
            np.testing.assert_allclose(
                np.asarray(a, np.float64), np.asarray(b, np.float64),
                rtol=2e-3, atol=1e-4,
            )


@pytest.mark.parametrize("n_data", [2, 4, 8])
def test_train_fast_data_mesh_matches_single_device(n_data):
    """train_fast(data_mesh=...) — the chunked convergence driver over
    em_train_scan_sharded, the --data-parallel path — must follow the
    single-device train_fast trajectory (iterations and log-prob history
    up to the order of the cross-device sum)."""
    from srhmm_tpu.train.em import train_fast

    model, batch = _toy()
    model = model.astype(jnp.float32)
    batch = batch.replace(features=batch.features.astype(jnp.float32))
    mesh = make_mesh(n_data=n_data, n_model=1, devices=jax.devices()[:n_data])
    ref = train_fast(model, batch, max_iterations=4, chunk=2)
    got = train_fast(model, batch, max_iterations=4, chunk=2, data_mesh=mesh)
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(
        got.log_prob_history, ref.log_prob_history, rtol=1e-5
    )
