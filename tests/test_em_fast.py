"""Fast-path (log-space, batched, jitted) EM vs the reference-exact parity
oracle, plus generative-model recovery and padding invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.init.lbg import create_initial_model
from srhmm_tpu.io import read_perfil
from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu.models import DIAG, FULL, GmmHmm, GmmStream, init_left_right_trans
from srhmm_tpu.train.em import e_step, train_fast
from srhmm_tpu.train.em_parity import train_word_parity


@pytest.fixture(scope="module")
def fixture_frames(reference_root):
    return read_perfil(
        reference_root
        / "train/test/perfil_data/mean_vc_186_f_03_ap_0225.perfil"
    )


def test_fast_f64_matches_parity_oracle(fixture_frames):
    init = create_initial_model([[fixture_frames]], 6, [1], cov_type="full")
    res_p = train_word_parity([[fixture_frames]], init)
    batch = pack_utterances([fixture_frames], pad_multiple=64, dtype=jnp.float64)
    res_f = train_fast(init, batch)
    assert res_f.iterations == res_p.iterations == 3
    np.testing.assert_allclose(res_f.mean_log_prob, res_p.mean_log_prob, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(res_f.model.trans), np.asarray(res_p.model.trans), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(res_f.model.streams[0].means),
        np.asarray(res_p.model.streams[0].means),
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(res_f.model.streams[0].inv_cov),
        np.asarray(res_p.model.streams[0].inv_cov),
        rtol=1e-5,  # Cholesky vs the reference's LDL^T
    )


def test_fast_f32_trains(fixture_frames):
    init = create_initial_model([[fixture_frames]], 6, [1], cov_type="full")
    batch = pack_utterances([fixture_frames], pad_multiple=64, dtype=jnp.float32)
    res = train_fast(init.astype(jnp.float32), batch)
    assert res.iterations == 3
    # f32 end-to-end stays within ~1 nat of the f64 result (-7928.72)
    assert abs(res.mean_log_prob - (-7928.7215)) < 1.0
    # log_det representation keeps normalization finite where raw f32
    # determinants would overflow
    assert np.isfinite(np.asarray(res.model.streams[0].log_det)).all()


def test_padding_invariance(fixture_frames):
    """E-step statistics must be identical whatever the time/batch padding."""
    init = create_initial_model([[fixture_frames]], 6, [1], cov_type="full")
    b1 = pack_utterances([fixture_frames], pad_multiple=1, dtype=jnp.float64)
    b2 = pack_utterances(
        [fixture_frames], pad_multiple=256, pad_batch_to=4, dtype=jnp.float64
    )
    s1 = e_step(init, b1)
    s2 = e_step(init, b2)
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-9)


def _sample_hmm(key, model: GmmHmm, T: int) -> np.ndarray:
    """Sample an observation sequence from a diag GMM-HMM."""
    rng = np.random.default_rng(key)
    S = model.num_states
    trans = np.asarray(model.trans)
    stream = model.streams[0]
    w = np.asarray(stream.weights)
    mu = np.asarray(stream.means)
    var = 1.0 / np.asarray(stream.inv_cov)
    s = 0
    out = []
    for _ in range(T):
        m = rng.choice(w.shape[1], p=w[s])
        out.append(rng.normal(mu[s, m], np.sqrt(var[s, m])))
        s = rng.choice(S, p=trans[s])
    return np.asarray(out)


def _toy_model(S=4, M=2, D=6, seed=0) -> GmmHmm:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, M, D)) * 4.0
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
    )


def test_generative_recovery_diag():
    """EM from a perturbed init recovers a known diag GMM-HMM: the final
    log-likelihood must beat the perturbed init's and approach the truth's."""
    truth = _toy_model()
    utts = [_sample_hmm(100 + i, truth, T=80 + 7 * i) for i in range(24)]
    batch = pack_utterances(utts, pad_multiple=32, dtype=jnp.float64)

    rng = np.random.default_rng(1)
    st = truth.streams[0]
    perturbed = truth.replace(
        streams=(
            st.replace(
                means=st.means + rng.normal(size=st.means.shape),
            ),
        )
    )
    from srhmm_tpu.train.em import em_step

    _, lp_perturbed, _ = em_step(perturbed, batch)
    _, lp_truth, _ = em_step(truth, batch)

    res = train_fast(perturbed, batch, threshold=1e-5, max_iterations=60)
    assert res.log_prob_history[-1] > float(lp_perturbed)
    # trained model should come close to (or beat) the generating model
    assert res.log_prob_history[-1] > float(lp_truth) - 0.02 * abs(float(lp_truth))
    # monotone to numerical tolerance
    h = res.log_prob_history
    assert all(h[i + 1] >= h[i] - 1e-6 * abs(h[i]) for i in range(len(h) - 1))


def test_pathological_full_cov_stays_finite(reference_root):
    """Over-parameterized full-cov init (18 Gaussians on ~400 frames) must not
    NaN out: diagonal-fallback repair keeps EM finite (the reference C would
    produce garbage here)."""
    words = ["vc_186_f_03_ap_0225", "vc_200_f_02_ap_015", "vc_254_f_03_ap_0225"]
    utts = [
        read_perfil(reference_root / f"train/test/perfil_data/mean_{w}.perfil")
        for w in words
    ]
    init = create_initial_model([utts], 6, [3], cov_type="full")
    batch = pack_utterances(utts, pad_multiple=64, dtype=jnp.float64)
    res = train_fast(init, batch, max_iterations=10, var_floor=1.0)
    assert np.isfinite(res.log_prob_history).all()
    assert np.isfinite(np.asarray(res.model.streams[0].log_det)).all()


def test_multi_stream_em():
    """Two-stream model (distinct feature files per stream, reference
    MAX_PARAMETERS_NUMBER capability): EM trains and matches the parity
    oracle on the fixture data split into two streams."""
    import numpy as np
    from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans
    from srhmm_tpu.train.em import em_step

    rng = np.random.default_rng(7)
    S, M = 4, 2
    streams = []
    for p, D in enumerate([5, 3]):
        means = rng.normal(size=(S, M, D)) * 3.0
        var = rng.uniform(0.6, 1.4, size=(S, M, D))
        w = rng.uniform(0.4, 0.6, size=(S, M))
        w /= w.sum(-1, keepdims=True)
        streams.append(
            GmmStream(
                weights=jnp.asarray(w),
                means=jnp.asarray(means),
                inv_cov=jnp.asarray(1.0 / var),
                det=jnp.asarray(np.prod(var, -1)),
                cov_type=DIAG,
            )
        )
    model = GmmHmm(trans=init_left_right_trans(S), streams=tuple(streams))
    lengths = [40, 52, 36]
    utts_s0 = [rng.normal(size=(L, 5)) for L in lengths]
    utts_s1 = [rng.normal(size=(L, 3)) for L in lengths]
    b0 = pack_utterances(utts_s0, pad_multiple=16, dtype=jnp.float64)
    b1 = pack_utterances(utts_s1, pad_multiple=16, dtype=jnp.float64)
    new_model, lp, nv = em_step(model, (b0, b1))
    assert float(nv) == 3
    assert np.isfinite(float(lp))
    # parity oracle on the same data
    from srhmm_tpu.train.em_parity import train_word_parity

    res = train_word_parity([utts_s0, utts_s1], model, max_iterations=1)
    np.testing.assert_allclose(float(lp), res.log_prob_history[0], rtol=1e-9)
    # second EM iteration improves the likelihood
    _, lp2, _ = em_step(new_model, (b0, b1))
    assert float(lp2) >= float(lp)


def test_lane_major_e_step_matches_vmapped():
    """The E-step on the lane-major lattice kernels (ops/lattice_triton.py,
    Pallas interpreter) must produce the same statistics as the vmapped
    per-utterance scans, in float64."""
    rng = np.random.default_rng(11)
    model = _toy_model(S=5, M=2, D=6, seed=3)
    utts = [rng.normal(size=(40 + 13 * i, 6)) for i in range(5)]
    batch = pack_utterances(utts, pad_multiple=32, pad_batch_to=8, dtype=jnp.float64)
    a = e_step(model, batch, lattice="xla")
    b = e_step(model, batch, lattice="triton", interpret=True)
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(
            np.asarray(la), np.asarray(lb), rtol=1e-9, atol=1e-9
        )


def test_multi_exemplar_full_cov_matches_parity(reference_root):
    """Multi-exemplar full-covariance training: fast f64 EM equals the
    reference-exact oracle on 3 fixture utterances for the full run."""
    words = ["vc_186_f_03_ap_0225", "vc_200_f_04_ap_015", "vc_254_f_03_ap_0225"]
    utts = [
        read_perfil(reference_root / f"train/test/perfil_data/mean_{w}.perfil")
        for w in words
    ]
    init = create_initial_model([utts], 6, [1], cov_type="full")
    res_p = train_word_parity([utts], init)
    batch = pack_utterances(utts, pad_multiple=64, dtype=jnp.float64)
    res_f = train_fast(init, batch)
    assert res_f.iterations == res_p.iterations
    np.testing.assert_allclose(res_f.mean_log_prob, res_p.mean_log_prob, rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(res_f.model.streams[0].means),
        np.asarray(res_p.model.streams[0].means),
        rtol=1e-8,
    )


def test_delta2_band_preserved_by_m_step():
    """Models with a wider transition band (delta=2) must keep their arcs
    through EM — the M-step's structural mask comes from the model's own
    support, not a hard-coded delta=1 band."""
    rng = np.random.default_rng(13)
    S, M, D = 5, 1, 4
    means = rng.normal(size=(S, M, D)) * 3.0
    var = np.ones((S, M, D))
    model = GmmHmm(
        trans=init_left_right_trans(S, delta=2),
        streams=(
            GmmStream(
                weights=jnp.ones((S, M)),
                means=jnp.asarray(means),
                inv_cov=jnp.asarray(1.0 / var),
                det=jnp.asarray(np.prod(var, -1)),
                cov_type=DIAG,
            ),
        ),
    )
    utts = [rng.normal(size=(60, D)) + np.repeat(means[:, 0], 12, axis=0) for _ in range(4)]
    batch = pack_utterances(utts, pad_multiple=16, dtype=jnp.float64)
    from srhmm_tpu.train.em import em_step

    new_model, lp, nv = em_step(model, batch)
    trans = np.asarray(new_model.trans)
    support = np.asarray(model.trans) > 0
    # skip-2 arcs (i -> i+2) must survive with nonzero probability mass
    assert trans[0, 2] > 0
    np.testing.assert_allclose(trans.sum(1)[:-1], 1.0, rtol=1e-9)
    assert (trans[~support] == 0).all()


def test_lane_major_pallas_lattices_match():
    """The Pallas lattice kernels in place of the XLA scans must produce the
    same statistics (f32, interpret mode on CPU)."""
    rng = np.random.default_rng(17)
    model = _toy_model(S=5, M=2, D=6, seed=3).astype(jnp.float32)
    utts = [rng.normal(size=(40 + 13 * i, 6)) for i in range(5)]
    batch = pack_utterances(utts, pad_multiple=32, pad_batch_to=8, dtype=jnp.float32)
    a = e_step(model, batch, lattice="xla")
    b = e_step(model, batch, lattice="triton", interpret=True)
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(
            np.asarray(la), np.asarray(lb), rtol=2e-4, atol=2e-4
        )


def test_bf16_stats_close_to_f32():
    """bf16-input moment GEMMs (f32 accumulation): stats within ~1e-3 of the
    f32 path even at modest batch (cancellation improves with scale; the
    hardware-measured error at B=2048 x T=500 is ~2e-6), and the EM step's
    log-prob is unaffected (it comes from the f32 lattices)."""
    from srhmm_tpu.train.em import em_step

    truth = _toy_model(seed=3)
    utts = [_sample_hmm(400 + i, truth, T=60 + 5 * i) for i in range(16)]
    batch = pack_utterances(utts, pad_multiple=32, dtype=jnp.float32)
    model = truth.astype(jnp.float32)

    s32 = e_step(model, batch)
    s16 = e_step(model, batch, bf16_stats=True)
    for a, b in [(s32.streams[0].w, s16.streams[0].w),
                 (s32.streams[0].x, s16.streams[0].x),
                 (s32.streams[0].xx, s16.streams[0].xx)]:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-3
    # transition stats don't touch the moment GEMMs at all
    np.testing.assert_allclose(
        np.asarray(s32.num_trans), np.asarray(s16.num_trans), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(s32.log_prob), float(s16.log_prob), rtol=1e-6
    )

    m32, lp32, _ = em_step(model, batch)
    m16, lp16, _ = em_step(model, batch, bf16_stats=True)
    np.testing.assert_allclose(float(lp32), float(lp16), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(m32.streams[0].means),
        np.asarray(m16.streams[0].means),
        rtol=5e-3, atol=5e-3,
    )
    assert np.isfinite(np.asarray(m16.streams[0].log_det)).all()


def test_bf16_stats_full_cov():
    """Full-covariance bf16 moment GEMMs stay close and PSD-invertible."""
    from srhmm_tpu.train.em import em_step

    rng = np.random.default_rng(8)
    S, M, D = 3, 2, 4
    means = rng.normal(size=(S, M, D)) * 3.0
    cov = np.einsum("smdk,smek->smde",
                    rng.normal(size=(S, M, D, D + 2)),
                    rng.normal(size=(S, M, D, D + 2))) / (D + 2)
    cov += 0.5 * np.eye(D)
    w = np.full((S, M), 1.0 / M)
    model = GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w, jnp.float32),
                means=jnp.asarray(means, jnp.float32),
                inv_cov=jnp.asarray(np.linalg.inv(cov), jnp.float32),
                det=jnp.asarray(np.linalg.det(cov), jnp.float32),
                cov_type=FULL,
            ),
        ),
    )
    utts = [
        np.cumsum(rng.normal(size=(70, D)), axis=0) * 0.2 + means[min(i, S - 1), 0]
        for i in range(12)
    ]
    batch = pack_utterances(utts, pad_multiple=32, dtype=jnp.float32)
    s32 = e_step(model, batch)
    s16 = e_step(model, batch, bf16_stats=True)
    a = np.asarray(s32.streams[0].xx, np.float64)
    b = np.asarray(s16.streams[0].xx, np.float64)
    assert np.abs(a - b).max() / np.abs(a).max() < 2e-3
    m16, lp16, _ = em_step(model, batch, bf16_stats=True)
    assert np.isfinite(float(lp16))
    assert np.isfinite(np.asarray(m16.streams[0].log_det)).all()


def test_em_train_scan_matches_loop():
    """em_train_scan (N iterations in one jitted lax.scan, no per-iteration
    host syncs) must follow the same trajectory as the em_step loop."""
    import jax

    from srhmm_tpu.train.em import em_step, em_train_scan

    S, M, D = 4, 2, 5
    rng = np.random.default_rng(0)
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
    ).astype(jnp.float32)
    utts = [rng.normal(size=(24 + i, D)) for i in range(8)]
    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)

    m = model
    lps_loop = []
    for _ in range(4):
        m, lp, nv = em_step(m, batch)
        lps_loop.append(float(lp))
    final, lps, nvs = em_train_scan(model, batch, 4)
    np.testing.assert_allclose(np.asarray(lps), np.asarray(lps_loop), rtol=1e-5)
    assert (np.asarray(nvs) == batch.batch_size).all()
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(m)):
        aa, bb = np.asarray(a, np.float64), np.asarray(b, np.float64)
        # f32 fusion-order differences between scanned and unscanned programs
        assert np.max(np.abs(aa - bb)) <= 1e-4 * max(1.0, np.abs(bb).max())


def test_global_cmvn_improves_f32_model_accuracy():
    """The f32 precision lever (PERF.md "Accuracy"): at raw .perfil-like
    feature scale (|x| ~ 3e3) the f32 moment statistics lose
    ~mean^2/variance of their precision to cancellation in the covariance
    recovery; training in globally-CMVN-normalized space
    (features.frontend.global_cmvn_stats) and de-normalizing the model
    (models.gmm_hmm.denormalize_model) recovers >=5x accuracy vs the f64
    oracle."""
    from srhmm_tpu.features.frontend import global_cmvn_stats
    from srhmm_tpu.io.dataset import pack_utterances
    from srhmm_tpu.models.gmm_hmm import denormalize_model
    from srhmm_tpu.train.em import em_step

    rng = np.random.default_rng(0)
    S, M, D, B, T = 8, 3, 9, 32, 64
    # .perfil-like monotone band profile: large per-dim offsets, modest spread
    offsets = np.linspace(50.0, 3000.0, D)
    state_means = offsets[None, :] + rng.normal(size=(S, D)) * 40.0
    utts = []
    for _ in range(B):
        ids = np.repeat(np.arange(S), T // S)
        utts.append(state_means[ids] + rng.normal(size=(T, D)) * 8.0)

    mix_means = state_means[:, None, :] + rng.normal(size=(S, M, D)) * 10.0
    var = rng.uniform(30.0, 90.0, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    model = GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w),
                means=jnp.asarray(mix_means),
                inv_cov=jnp.asarray(1.0 / var),
                det=jnp.asarray(np.prod(var, -1)),
                cov_type=DIAG,
            ),
        ),
    )

    batch64 = pack_utterances(utts, pad_multiple=16, dtype=jnp.float64)
    batch32 = batch64.replace(features=batch64.features.astype(jnp.float32))

    # f64 oracle in raw space
    m64, _, _ = em_step(model.astype(jnp.float64), batch64)
    # f32 in raw space
    m32, _, _ = em_step(model.astype(jnp.float32), batch32)
    # f32 in normalized space, de-normalized back
    mean, std = global_cmvn_stats(batch64.features, batch64.lengths)
    norm64 = batch64.replace(features=(batch64.features - mean) / std)
    norm32 = norm64.replace(features=norm64.features.astype(jnp.float32))
    model_n = denormalize_model(model, (-mean / std, 1.0 / std))
    m32n, _, _ = em_step(model_n.astype(jnp.float32), norm32)
    m32n = denormalize_model(m32n, (mean, std))

    def var_err(got):
        a = 1.0 / np.asarray(got.streams[0].inv_cov, np.float64)
        b = 1.0 / np.asarray(m64.streams[0].inv_cov, np.float64)
        return np.max(np.abs(a - b) / np.abs(b))

    raw_err, cmvn_err = var_err(m32), var_err(m32n)
    assert cmvn_err * 5.0 <= raw_err, (raw_err, cmvn_err)


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_multi_stream_fused_matches_xla(cov_type):
    """The multi-stream E-step on the lattice kernels (per-stream emissions
    summed before the lattices, Pallas interpreter) must reproduce the XLA
    e_step for a two-stream model, both covariance types, padded/odd
    shapes and a zero-length row."""
    import numpy as np

    from srhmm_tpu.models import GmmHmm, GmmStream, init_left_right_trans
    from srhmm_tpu.train.em import e_step

    rng = np.random.default_rng(3)
    S, M = 4, 2
    streams = []
    for p, D in enumerate([5, 3]):
        means = rng.normal(size=(S, M, D)) * 2.0
        w = rng.uniform(0.4, 0.6, size=(S, M))
        w /= w.sum(-1, keepdims=True)
        if cov_type == "full":
            a_rnd = rng.normal(size=(S, M, D, D)) * 0.2
            cov = a_rnd @ np.swapaxes(a_rnd, -1, -2) + np.eye(D)[None, None]
            inv_cov, det = np.linalg.inv(cov), np.linalg.det(cov)
        else:
            var = rng.uniform(0.6, 1.4, size=(S, M, D))
            inv_cov, det = 1.0 / var, np.prod(var, -1)
        streams.append(
            GmmStream(
                weights=jnp.asarray(w),
                means=jnp.asarray(means),
                inv_cov=jnp.asarray(inv_cov),
                det=jnp.asarray(det),
                cov_type=cov_type,
            )
        )
    model = GmmHmm(
        trans=init_left_right_trans(S), streams=tuple(streams)
    ).astype(jnp.float32)
    lengths = [40, 52, 36, 0, 47]
    b0 = pack_utterances(
        [rng.normal(size=(max(L, 1), 5)) for L in lengths],
        pad_multiple=1, dtype=jnp.float32,
    )
    b1 = pack_utterances(
        [rng.normal(size=(max(L, 1), 3)) for L in lengths],
        pad_multiple=1, dtype=jnp.float32,
    )
    # emulate a zero-length padded row (batch-axis padding)
    b0 = b0.replace(lengths=jnp.asarray(lengths, jnp.int32))
    b1 = b1.replace(lengths=jnp.asarray(lengths, jnp.int32))

    ref = e_step(model, (b0, b1))
    got = e_step(model, (b0, b1), lattice="triton", interpret=True)
    for name in ["num_trans", "den_trans", "den_mix", "log_prob", "num_valid"]:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        np.testing.assert_allclose(
            b, a, rtol=2e-3, atol=2e-4 * max(np.abs(a).max(), 1.0)
        )
    for p in range(2):
        for name in ["w", "x", "xx"]:
            a = np.asarray(getattr(ref.streams[p], name))
            b = np.asarray(getattr(got.streams[p], name))
            np.testing.assert_allclose(
                b, a, rtol=2e-3, atol=2e-4 * max(np.abs(a).max(), 1e-6)
            )
