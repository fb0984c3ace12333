"""Tied-state (senone) training: untied map reproduces embedded training;
shared senones accumulate pooled statistics; materialize() feeds decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans, stack_models
from srhmm_tpu.models.tying import TiedHmmSet, tie_from_models, untied_state_map
from srhmm_tpu.train.embedded import utterance_stats
from srhmm_tpu.train.tied import tied_batch_stats, tied_em_step, train_tied


def _unit(seed, S=3, M=2, D=5):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * 5.0
    var = rng.uniform(0.8, 1.2, size=(S, M, D))
    w = rng.uniform(0.4, 0.6, size=(S, M))
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


@pytest.fixture(scope="module")
def setup():
    units = [_unit(i) for i in range(4)]
    stacked = stack_models(units)
    rng = np.random.default_rng(0)
    transcripts = [[0, 1, 2], [2, 3, 0], [1, 0, 3]]
    utts = []
    for tr in transcripts:
        frames = []
        for u in tr:
            mu = np.asarray(units[u].streams[0].means)
            for s in range(3):
                for _ in range(5):
                    frames.append(mu[s, 0] + 0.3 * rng.normal(size=5))
        utts.append(np.asarray(frames))
    return stacked, utts, transcripts


def test_untied_matches_embedded(setup):
    """With the identity (no-sharing) map, tied stats equal embedded stats."""
    stacked, utts, transcripts = setup
    P, S = 4, 3
    tied = tie_from_models(stacked, np.asarray(untied_state_map(P, S)))
    tr = jnp.asarray(transcripts[0], jnp.int32)
    feats = jnp.asarray(utts[0])
    ln = jnp.asarray(len(utts[0]))

    sen_stats, den_mix, num_trans, den_trans, lp, valid = tied_batch_stats(
        tied, tr[None], feats[None], ln[None]
    )
    emb = utterance_stats(stacked, tr, feats, ln)
    np.testing.assert_allclose(float(lp), float(emb.log_prob), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(num_trans), np.asarray(emb.num_trans), rtol=1e-8, atol=1e-10
    )
    # senone stats reshape back to (P, S, M)
    np.testing.assert_allclose(
        np.asarray(sen_stats.w).reshape(P, S, -1),
        np.asarray(emb.streams[0].w),
        rtol=1e-8,
        atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(den_mix).reshape(P, S),
        np.asarray(emb.den_mix),
        rtol=1e-8,
        atol=1e-10,
    )


def test_shared_senones_pool_statistics(setup):
    """Mapping two units' states to the same senones pools their occupancy."""
    stacked, utts, transcripts = setup
    S = 3
    # units 0 and 1 share senones 0..2; units 2,3 private
    sm = np.asarray([[0, 1, 2], [0, 1, 2], [3, 4, 5], [6, 7, 8]])
    tied = tie_from_models(stacked, sm)
    assert tied.num_senones == 9
    tr = jnp.asarray([0, 1], jnp.int32)  # both units -> shared senones
    feats = jnp.asarray(utts[0][:30])
    sen_stats, den_mix, *_ = tied_batch_stats(
        tied, tr[None], feats[None], jnp.asarray([30])
    )
    # all occupancy lands in senones 0..2
    assert float(np.asarray(den_mix)[3:].sum()) == 0.0
    np.testing.assert_allclose(float(np.asarray(den_mix).sum()), 30.0, rtol=1e-6)


def test_tied_training_improves(setup):
    stacked, utts, transcripts = setup
    sm = np.asarray([[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]])  # 2-way tying
    tied = tie_from_models(stacked, sm)
    res = train_tied(tied, utts, transcripts, threshold=1e-5, max_iterations=20)
    h = res.log_prob_history
    assert all(h[i + 1] >= h[i] - 1e-6 * abs(h[i]) for i in range(len(h) - 1))
    assert np.isfinite(h).all()


def test_materialize_feeds_decode(setup):
    stacked, utts, transcripts = setup
    P, S = 4, 3
    tied = tie_from_models(stacked, np.asarray(untied_state_map(P, S)))
    mat = tied.materialize()
    assert mat.trans.shape == (P, S, S)
    assert mat.streams[0].means.shape == (P, S, 2, 5)
    # untied materialization reproduces the original models exactly
    np.testing.assert_allclose(
        np.asarray(mat.streams[0].means),
        np.asarray(stacked.streams[0].means),
        rtol=1e-12,
    )
    from srhmm_tpu.decode.continuous import decode_continuous

    hyps = decode_continuous(mat, jnp.asarray(utts[0]), n_best=1)
    assert hyps[0][1] == transcripts[0]


def test_tied_em_step_jit(setup):
    stacked, utts, transcripts = setup
    sm = np.asarray([[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]])
    tied = tie_from_models(stacked, sm)
    L = 3
    T = max(len(u) for u in utts)
    feats = np.zeros((len(utts), T, 5))
    lengths = np.zeros(len(utts), np.int32)
    trs = np.zeros((len(utts), L), np.int32)
    for i, (u, tr) in enumerate(zip(utts, transcripts)):
        feats[i, : len(u)] = u
        lengths[i] = len(u)
        trs[i] = tr
    new_tied, lp, nv = tied_em_step(
        tied, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lengths)
    )
    assert int(nv) == 3
    assert np.isfinite(float(lp))
    # senone weights remain normalized
    w = np.asarray(new_tied.senones.weights)
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-6)


def _materialized_reference(tied, transcripts, feats, lengths):
    """Senone-space statistics through the EMBEDDED path: batch_stats on
    the materialized per-unit models, each (unit, state) row summed into
    its senone — independent of the tied positional code."""
    from srhmm_tpu.train.embedded import batch_stats

    ref = batch_stats(tied.materialize(), transcripts, feats, lengths)
    sm = np.asarray(tied.state_map).reshape(-1)
    N = tied.num_senones

    def fold(a):
        a = np.asarray(a, np.float64)
        out = np.zeros((N,) + a.shape[2:])
        np.add.at(out, sm, a.reshape((-1,) + a.shape[2:]))
        return out

    st = ref.streams[0]
    return (
        (fold(st.w), fold(st.x), fold(st.xx)),
        fold(ref.den_mix),
        np.asarray(ref.num_trans),
        np.asarray(ref.den_trans),
        float(ref.log_prob),
        float(ref.num_valid),
    )


def _check_tied(got, ref, rtol):
    for f, a in zip(["w", "x", "xx"], ref[0]):
        b = np.asarray(getattr(got[0], f))
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(1.0, np.abs(a).max()))
    for i in (1, 2, 3):
        a, b = np.asarray(ref[i]), np.asarray(got[i])
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(1.0, np.abs(a).max()))
    np.testing.assert_allclose(float(got[4]), ref[4], rtol=rtol)
    assert float(got[5]) == ref[5]


def test_tied_batch_stats_fused_matches_xla():
    """tied_batch_stats (senone-space scatter of positional statistics)
    reproduces the embedded path on the materialized units folded by the
    state map, incl. shared senones and ragged lengths (float64)."""
    from srhmm_tpu.bench.suite import _rand_model

    P, S, M, D, B, T, L, N = 6, 3, 2, 5, 4, 32, 3, 10
    rng = np.random.default_rng(0)
    units = [
        _rand_model(np.random.default_rng(100 + i), S, M, D, jnp.float64)
        .replace(word=f"t{i}")
        for i in range(P)
    ]
    sm = rng.integers(0, N, size=(P, S)).astype(np.int32)
    sm[:4, :] = np.minimum(np.arange(4 * S).reshape(-1, S), N - 1)
    tied = tie_from_models(stack_models(units), sm)
    tr = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)))
    lengths = jnp.asarray([32, 20, 32, 9], jnp.int32)

    got = tied_batch_stats(tied, tr, feats, lengths)
    _check_tied(got, _materialized_reference(tied, tr, feats, lengths), 1e-8)


def test_tied_batch_stats_fused_full_cov_matches_xla():
    """FULL-covariance senones: tied_batch_stats reproduces the embedded
    path on the materialized units, incl. (D, D) second moments."""
    from test_embedded import _full_unit

    P, S, M, D, B, T, L, N = 4, 3, 2, 4, 3, 24, 3, 8
    rng = np.random.default_rng(3)
    units = [_full_unit(200 + i, S=S, M=M, D=D) for i in range(P)]
    sm = rng.integers(0, N, size=(P, S)).astype(np.int32)
    sm[0] = [0, 1, 2]
    tied = tie_from_models(stack_models(units), sm).astype(jnp.float64)
    tr = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0)
    lengths = jnp.asarray([T, 15, T - 2], jnp.int32)

    got = tied_batch_stats(tied, tr, feats, lengths)
    _check_tied(got, _materialized_reference(tied, tr, feats, lengths), 1e-6)


def test_train_tied_driver_fused_matches_xla(setup):
    """The train_tied DRIVER data-parallel over a 4-device mesh
    (tied_train_scan_sharded, empty pad utterances) follows the
    single-device trajectory."""
    from srhmm_tpu.parallel.mesh import make_mesh

    stacked, utts, transcripts = setup
    P, S = stacked.trans.shape[0], stacked.trans.shape[-1]
    sm = np.arange(P * S).reshape(P, S) % (P * S // 2)  # 2-way sharing
    tied = tie_from_models(stacked, sm.astype(np.int32)).astype(jnp.float32)
    mesh = make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    r_one = train_tied(tied, utts, transcripts, threshold=1e-4, max_iterations=4)
    r_dp = train_tied(
        tied, utts, transcripts, threshold=1e-4, max_iterations=4, mesh=mesh
    )
    assert r_dp.iterations == r_one.iterations
    np.testing.assert_allclose(
        r_dp.log_prob_history, r_one.log_prob_history, rtol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(r_dp.model.senones.means),
        np.asarray(r_one.model.senones.means),
        rtol=2e-3, atol=2e-3,
    )
