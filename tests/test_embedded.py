"""Embedded re-estimation over transcript-composed chains."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans, stack_models
from srhmm_tpu.train.em import em_step
from srhmm_tpu.train.embedded import train_embedded, utterance_stats
from srhmm_tpu.io.dataset import pack_utterances


def _unit(seed, S=3, M=2, D=5, spread=5.0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * spread
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


def _sample_units(unit_models, transcript, rng, frames_per_state=5):
    out = []
    for u in transcript:
        mu = np.asarray(unit_models[u].streams[0].means)
        w = np.asarray(unit_models[u].streams[0].weights)
        for s in range(mu.shape[0]):
            for _ in range(frames_per_state):
                m = rng.choice(mu.shape[1], p=w[s])
                out.append(mu[s, m] + 0.3 * rng.normal(size=mu.shape[2]))
    return np.asarray(out)


@pytest.fixture(scope="module")
def setup():
    units = [_unit(i) for i in range(4)]
    stacked = stack_models(units)
    rng = np.random.default_rng(0)
    transcripts = [
        [0, 1, 2],
        [2, 3, 0],
        [1, 0, 3],
        [3, 2, 1],
        [0, 2, 1, 3],
        [1, 3, 0, 2],
    ]
    utts = [_sample_units(units, tr, rng) for tr in transcripts]
    return stacked, utts, transcripts


def test_single_unit_transcript_equals_isolated_em(setup):
    """A 1-unit transcript reduces embedded stats to the isolated E-step."""
    stacked, _, _ = setup
    rng = np.random.default_rng(1)
    feats = jnp.asarray(rng.normal(size=(40, 5)))
    length = jnp.asarray(40)
    st_emb = utterance_stats(
        stacked, jnp.asarray([1], dtype=jnp.int32), feats, length
    )
    # isolated E-step on unit 1
    from srhmm_tpu.train.em import _per_utterance_stats

    unit1 = jax.tree.map(lambda a: a[1], stacked.replace(word=""))
    st_iso = _per_utterance_stats(unit1, feats, length)
    np.testing.assert_allclose(
        float(st_emb.log_prob), float(st_iso.log_prob), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(st_emb.num_trans[1]), np.asarray(st_iso.num_trans), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(st_emb.streams[0].w[1]),
        np.asarray(st_iso.streams[0].w),
        rtol=1e-9,
    )
    # other units untouched
    assert np.asarray(st_emb.streams[0].w[0]).sum() == 0.0
    assert np.asarray(st_emb.streams[0].w[2:]).sum() == 0.0


def test_embedded_training_improves_and_converges(setup):
    stacked, utts, transcripts = setup
    rng = np.random.default_rng(2)
    st = stacked.streams[0]
    perturbed = stacked.replace(
        streams=(st.replace(means=st.means + 0.7 * rng.normal(size=st.means.shape)),)
    )
    res = train_embedded(
        perturbed, utts, transcripts, threshold=1e-5, max_iterations=30
    )
    h = res.log_prob_history
    assert res.exemplar_count == len(utts)
    assert all(h[i + 1] >= h[i] - 1e-6 * abs(h[i]) for i in range(len(h) - 1))
    # trained units should beat the perturbed start substantially
    assert h[-1] > h[0] + 10.0


def test_embedded_gamma_mass_conservation(setup):
    """Per-frame occupancy sums to 1 over the composed lattice."""
    stacked, utts, transcripts = setup
    from srhmm_tpu.train.embedded import utterance_stats

    tr = jnp.asarray(transcripts[0], dtype=jnp.int32)
    feats = jnp.asarray(utts[0])
    stats = utterance_stats(stacked, tr, feats, jnp.asarray(len(utts[0])))
    # total occupancy = num frames
    total = float(sum(np.asarray(s.w).sum() for s in stats.streams))
    np.testing.assert_allclose(total, len(utts[0]), rtol=1e-6)


def _stats_close(ref, got, rtol):
    for name in ["num_trans", "den_trans", "den_mix"]:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(1.0, np.abs(a).max()))
    np.testing.assert_allclose(
        float(got.log_prob), float(ref.log_prob), rtol=rtol
    )
    assert float(got.num_valid) == float(ref.num_valid)
    for p in range(len(ref.streams)):
        for f in ["w", "x", "xx"]:
            a = np.asarray(getattr(ref.streams[p], f))
            b = np.asarray(getattr(got.streams[p], f))
            np.testing.assert_allclose(
                b, a, rtol=rtol, atol=rtol * max(1.0, np.abs(a).max())
            )


def _concatenated_reference(models, transcripts, feats, lengths):
    """Unit-space statistics computed independently of batch_stats: per
    utterance, the isolated E-step on the concatenated chain model
    (models.concat_models), folded back onto the units — within-unit
    transition blocks, and each chain arc's flow onto its unit's exit
    self-loop."""
    from srhmm_tpu.models import concat_models
    from srhmm_tpu.train.em import StreamStats, SuffStats, _per_utterance_stats

    P, S = models.trans.shape[0], models.trans.shape[-1]
    trs = np.asarray(transcripts)
    acc = None
    for b in range(trs.shape[0]):
        chain = concat_models(models, trs[b])
        st = _per_utterance_stats(chain, feats[b], lengths[b])
        L = trs.shape[1]
        nt = np.zeros((P, S, S))
        dt = np.zeros((P, S))
        dm = np.zeros((P, S))
        num = np.asarray(st.num_trans, np.float64)
        streams = []
        for k, u in enumerate(trs[b]):
            blk = slice(k * S, (k + 1) * S)
            nt[u] += num[blk, blk]
            if k + 1 < L:
                nt[u, S - 1, S - 1] += num[k * S + S - 1, (k + 1) * S]
            dt[u] += np.asarray(st.den_trans)[blk]
            dm[u] += np.asarray(st.den_mix)[blk]
        for ps in st.streams:
            fold = []
            for arr in (ps.w, ps.x, ps.xx):
                arr = np.asarray(arr, np.float64)
                out = np.zeros((P, S) + arr.shape[1:])
                for k, u in enumerate(trs[b]):
                    out[u] += arr[k * S : (k + 1) * S]
                fold.append(out)
            streams.append(StreamStats(*fold))
        one = SuffStats(
            num_trans=nt, den_trans=dt, den_mix=dm, streams=tuple(streams),
            log_prob=float(st.log_prob), num_valid=float(st.num_valid),
        )
        acc = one if acc is None else jax.tree.map(np.add, acc, one)
    return acc


@pytest.mark.parametrize("S,M,L,delta", [(3, 2, 3, 1), (4, 1, 2, 2), (2, 3, 5, 1)])
def test_batch_stats_fused_matches_xla(S, M, L, delta):
    """batch_stats (vmapped positional statistics + one scatter into unit
    space) reproduces the concatenated-chain reference across state
    counts, mixture counts, transcript lengths, band widths and ragged
    lengths, in float64."""
    from srhmm_tpu.train.embedded import batch_stats

    P, D, B, T = 5, 4, 4, 32
    rng = np.random.default_rng(S * 100 + M * 10 + L)
    units = []
    for i in range(P):
        u = _unit(i, S=S, M=M, D=D)
        units.append(u.replace(trans=init_left_right_trans(S, delta=delta)))
    models = stack_models(units)
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0)
    lengths = jnp.asarray([T, T - 13, max(L * S, 3), T - 1], jnp.int32)

    got = batch_stats(models, transcripts, feats, lengths)
    ref = _concatenated_reference(models, transcripts, feats, lengths)
    _stats_close(ref, got, rtol=1e-8)


def _full_unit(seed, S=3, M=2, D=4, spread=3.0):
    from srhmm_tpu.models import FULL

    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * spread
    a = rng.normal(size=(S, M, D, D + 2))
    cov = np.einsum("smdk,smek->smde", a, a) / (D + 2)  # symmetric PD
    cov += 0.5 * np.eye(D)
    w = rng.uniform(0.4, 0.6, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    return GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w, jnp.float32),
                means=jnp.asarray(means, jnp.float32),
                inv_cov=jnp.asarray(np.linalg.inv(cov), jnp.float32),
                det=jnp.asarray(np.linalg.det(cov), jnp.float32),
                cov_type="full",
            ),
        ),
        word=f"f{seed}",
    )


@pytest.mark.parametrize("S,M,L", [(3, 2, 3), (2, 3, 4)])
def test_batch_stats_fused_full_cov_matches_xla(S, M, L):
    """FULL covariance (the reference's canonical T1 regime): batch_stats
    reproduces the concatenated-chain reference, including the (D, D)
    second-moment statistics."""
    from srhmm_tpu.train.embedded import batch_stats

    P, D, B, T = 4, 4, 3, 24
    rng = np.random.default_rng(S * 10 + M)
    models = stack_models(
        [_full_unit(i, S=S, M=M, D=D) for i in range(P)]
    ).astype(jnp.float64)
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0)
    lengths = jnp.asarray([T, T - 7, max(L * S, 3)], jnp.int32)

    got = batch_stats(models, transcripts, feats, lengths)
    ref = _concatenated_reference(models, transcripts, feats, lengths)
    _stats_close(ref, got, rtol=1e-6)


def test_embedded_em_step_fused_trains_identically():
    """Two embedded_em_step calls and the driver's two-iteration chunk scan
    (_embedded_chunk) produce matching models and log probs."""
    from srhmm_tpu.train.embedded import _embedded_chunk, embedded_em_step

    P, S, M, D, B, T, L = 4, 3, 2, 5, 3, 24, 3
    rng = np.random.default_rng(7)
    models = stack_models([_unit(i, S=S, M=M, D=D) for i in range(P)]).astype(
        jnp.float32
    )
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0, jnp.float32)
    lengths = jnp.asarray([T, T - 5, T - 2], jnp.int32)

    mx = models
    lps = []
    for _ in range(2):
        mx, lpx, _ = embedded_em_step(mx, transcripts, feats, lengths)
        lps.append(float(lpx))
    mc, lpc, _ = _embedded_chunk(models, ((transcripts, feats, lengths),), 2, 0.0)
    np.testing.assert_allclose(np.asarray(lpc), lps, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(mc.trans), np.asarray(mx.trans), rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(mc.streams[0].means),
        np.asarray(mx.streams[0].means),
        rtol=1e-3, atol=1e-3,
    )


def test_train_embedded_driver_fused_matches_xla(setup):
    """The train_embedded DRIVER data-parallel over a 4-device mesh
    (embedded_train_scan_sharded, empty pad utterances) follows the
    single-device trajectory."""
    from srhmm_tpu.parallel.mesh import make_mesh

    stacked, utts, transcripts = setup
    rng = np.random.default_rng(5)
    st = stacked.streams[0]
    perturbed = stacked.replace(
        streams=(st.replace(means=st.means + 0.5 * rng.normal(size=st.means.shape)),)
    ).astype(jnp.float32)
    mesh = make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    r_one = train_embedded(
        perturbed, utts, transcripts, threshold=1e-4, max_iterations=5
    )
    r_dp = train_embedded(
        perturbed, utts, transcripts, threshold=1e-4, max_iterations=5,
        mesh=mesh,
    )
    assert r_dp.iterations == r_one.iterations
    np.testing.assert_allclose(
        r_dp.log_prob_history, r_one.log_prob_history, rtol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(r_dp.model.streams[0].means),
        np.asarray(r_one.model.streams[0].means),
        rtol=2e-3, atol=2e-3,
    )


def test_batch_stats_fused_multi_stream_matches_xla():
    """MULTI-STREAM embedded models (product-of-streams emission,
    T1:1437-1441): batch_stats reproduces the concatenated-chain reference
    for both streams."""
    from srhmm_tpu.train.embedded import batch_stats

    P, S, D, B, T, L = 4, 3, 4, 3, 24, 3
    rng = np.random.default_rng(11)

    def unit2(seed):
        u1 = _unit(seed, S=S, M=2, D=D)
        u2 = _unit(seed + 50, S=S, M=3, D=D)
        return u1.replace(streams=(u1.streams[0], u2.streams[0]))

    models = stack_models([unit2(i) for i in range(P)])
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0)
    lengths = jnp.asarray([T, T - 7, max(L * S, 3)], jnp.int32)

    got = batch_stats(models, transcripts, feats, lengths)
    ref = _concatenated_reference(models, transcripts, feats, lengths)
    _stats_close(ref, got, rtol=1e-8)


def test_batch_stats_fused_multi_stream_full_cov_matches_xla():
    """Multi-stream AND full covariance together."""
    from srhmm_tpu.train.embedded import batch_stats

    P, S, D, B, T, L = 3, 2, 3, 2, 16, 2
    rng = np.random.default_rng(21)

    def unit2(seed):
        u1 = _full_unit(seed, S=S, M=2, D=D)
        u2 = _full_unit(seed + 70, S=S, M=1, D=D)
        return u1.replace(streams=(u1.streams[0], u2.streams[0]))

    models = stack_models([unit2(i) for i in range(P)]).astype(jnp.float64)
    transcripts = jnp.asarray(rng.integers(0, P, size=(B, L)), jnp.int32)
    feats = jnp.asarray(rng.normal(size=(B, T, D)) * 2.0)
    lengths = jnp.asarray([T, T - 5], jnp.int32)

    got = batch_stats(models, transcripts, feats, lengths)
    ref = _concatenated_reference(models, transcripts, feats, lengths)
    _stats_close(ref, got, rtol=1e-6)
