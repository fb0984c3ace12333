"""Continuous decoding: composed word-loop token passing, N-best, forced
alignment via sequence composition."""

import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.decode.continuous import (
    compose_sequence,
    compose_word_loop,
    composed_emissions,
    decode_continuous,
    emissions_for_graph,
    token_passing,
    backtrace_words,
)
from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans, stack_models


def _word_model(seed, S=3, D=4):
    """A 1-mixture diag model with distinctive means per word."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(S, 1, D)) * 6.0
    var = np.full((S, 1, D), 1.0)
    return GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.ones((S, 1)),
                means=jnp.asarray(means),
                inv_cov=jnp.asarray(1.0 / var),
                det=jnp.asarray(np.prod(var, -1)),
                cov_type=DIAG,
            ),
        ),
        word=f"w{seed}",
    )


def _sample_word(model, rng, frames_per_state=4):
    mu = np.asarray(model.streams[0].means)[:, 0]
    out = []
    for s in range(mu.shape[0]):
        for _ in range(frames_per_state):
            out.append(mu[s] + 0.1 * rng.normal(size=mu.shape[1]))
    return np.asarray(out)


@pytest.fixture(scope="module")
def vocab():
    return stack_models([_word_model(i) for i in range(5)])


def test_decode_recovers_word_string(vocab):
    rng = np.random.default_rng(0)
    truth = [2, 0, 4, 1]
    frames = np.concatenate(
        [_sample_word(_word_model(w), rng) for w in truth]
    )
    hyps = decode_continuous(vocab, jnp.asarray(frames), n_best=1)
    score, words, spans = hyps[0]
    assert words == truth
    # spans tile the utterance
    assert spans[0][0] == 0 and spans[-1][1] == len(frames)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))
    # each word's span should be ~12 frames (4/state x 3 states)
    for (a, b) in spans:
        assert 8 <= b - a <= 16


def test_n_best_contains_truth_first(vocab):
    rng = np.random.default_rng(1)
    truth = [3, 1]
    frames = np.concatenate([_sample_word(_word_model(w), rng) for w in truth])
    hyps = decode_continuous(vocab, jnp.asarray(frames), n_best=3)
    assert len(hyps) >= 2
    assert hyps[0][1] == truth
    scores = [h[0] for h in hyps]
    assert scores == sorted(scores, reverse=True)
    assert len({tuple(h[1]) for h in hyps}) == len(hyps)  # distinct strings


def test_forced_alignment_matches_truth_segmentation(vocab):
    rng = np.random.default_rng(2)
    truth = [0, 2, 2, 1]
    per_word = [_sample_word(_word_model(w), rng) for w in truth]
    frames = jnp.asarray(np.concatenate(per_word))
    graph = compose_sequence(vocab, truth)
    log_b = emissions_for_graph(vocab, graph, frames)
    final, bps = token_passing(graph, log_b, n_best=1)
    # force the END of the transcript: last unit's exit state
    exit_last = int(np.asarray(graph.exit_states)[-1])
    score = float(np.asarray(final)[exit_last, 0])
    assert np.isfinite(score)
    _, words, spans = backtrace_words(
        graph, np.asarray(final), np.asarray(bps), log_b.shape[0]
    )
    assert words == truth
    # boundaries within 2 frames of the true 12-frame grid
    for i, (a, b) in enumerate(spans):
        assert abs(a - 12 * i) <= 2


def test_word_loop_graph_shapes(vocab):
    g = compose_word_loop(vocab)
    S_tot = 5 * 3
    assert g.log_trans.shape == (S_tot, S_tot)
    # exactly W exit->entry arc rows exist
    lt = np.asarray(g.log_trans)
    for w, ex in enumerate(np.asarray(g.exit_states)):
        finite = np.isfinite(lt[ex])
        # self-loop + all 5 entries
        assert finite.sum() >= 5
    frames = jnp.asarray(np.random.default_rng(3).normal(size=(10, 4)))
    lb = composed_emissions(vocab, frames)
    assert lb.shape == (10, S_tot)


def test_beam_pruning_preserves_result_with_generous_beam(vocab):
    """A generous beam must not change the 1-best result; a tiny beam still
    yields a finite hypothesis (the best path survives by construction)."""
    from srhmm_tpu.decode.continuous import (
        compose_word_loop,
        composed_emissions,
        token_passing,
        backtrace_words,
    )

    rng = np.random.default_rng(7)
    truth = [1, 4, 0]
    frames = jnp.asarray(
        np.concatenate([_sample_word(_word_model(w), rng) for w in truth])
    )
    graph = compose_word_loop(vocab)
    log_b = composed_emissions(vocab, frames)

    f_exact, bp_exact = token_passing(graph, log_b, n_best=1)
    s0, w0, _ = backtrace_words(
        graph, np.asarray(f_exact), np.asarray(bp_exact), log_b.shape[0]
    )
    f_beam, bp_beam = token_passing(graph, log_b, n_best=1, beam=200.0)
    s1, w1, _ = backtrace_words(
        graph, np.asarray(f_beam), np.asarray(bp_beam), log_b.shape[0]
    )
    assert w0 == w1 == truth
    np.testing.assert_allclose(s0, s1, rtol=1e-6)

    f_tiny, bp_tiny = token_passing(graph, log_b, n_best=1, beam=5.0)
    s2, w2, _ = backtrace_words(
        graph, np.asarray(f_tiny), np.asarray(bp_tiny), log_b.shape[0]
    )
    assert np.isfinite(s2)
    assert w2 == truth  # easy synthetic task survives a tight beam


def test_bigram_graph_arc_weights(vocab):
    """Arc weights out of word w's exit state must be exit + lm_scale *
    bigram[w] + penalty; entry scores must be lm_scale * initial."""
    W, S = 5, 3
    rng = np.random.default_rng(3)
    bigram = np.log(rng.dirichlet(np.ones(W), size=W))
    initial = np.log(rng.dirichlet(np.ones(W)))
    exit_lp, scale, pen = np.log(0.2), 1.3, -0.7
    g = compose_word_loop(
        vocab,
        bigram,
        exit_logprob=exit_lp,
        lm_scale=scale,
        word_insertion_penalty=pen,
        lm_initial=initial,
    )
    lt = np.asarray(g.log_trans)
    entry = np.asarray(g.entry_states)
    exit_ = np.asarray(g.exit_states)
    for w in range(W):
        # the word's own exit->own-entry arc: with S > 1 the entry state is
        # distinct from the exit state, so no internal left-right arc competes
        # and the LM arc weight must land exactly
        np.testing.assert_allclose(
            lt[exit_[w], entry[w]],
            exit_lp + scale * bigram[w, w] + pen,
            rtol=1e-12,
        )
        # arcs into OTHER words' entries are exactly the LM arc weight
        others = [v for v in range(W) if v != w]
        np.testing.assert_allclose(
            lt[exit_[w], entry[others]],
            exit_lp + scale * bigram[w, others] + pen,
            rtol=1e-12,
        )
    np.testing.assert_allclose(
        np.asarray(g.log_entry)[entry], scale * initial, rtol=1e-12
    )


def test_bigram_lm_steers_identical_acoustics():
    """With an acoustically identical vocabulary the bigram LM alone decides
    the word string: expect the argmax chain initial -> bigram -> bigram."""
    base = _word_model(0)
    W = 4
    models = [base.replace(word=f"w{i}") for i in range(W)]
    vocab5 = stack_models(models)

    rng = np.random.default_rng(9)
    frames = np.concatenate([_sample_word(base, rng) for _ in range(3)])

    bigram = np.full((W, W), np.log(0.01 / (W - 1)))
    chain = {0: 2, 2: 1, 1: 3}
    for a, b in chain.items():
        bigram[a, b] = np.log(0.99)
    initial = np.log(np.full(W, 0.01 / (W - 1)))
    initial[0] = np.log(0.99)

    g = compose_word_loop(vocab5, bigram, lm_initial=initial)
    log_b = composed_emissions(vocab5, jnp.asarray(frames))
    final, bps = token_passing(g, log_b, n_best=1)
    score, words, spans = backtrace_words(
        g, np.asarray(final), np.asarray(bps), log_b.shape[0]
    )
    assert words == [0, 2, 1]
    # and a reversed-chain LM flips the decode
    bigram_rev = np.full((W, W), np.log(0.01 / (W - 1)))
    for a, b in {1: 2, 2: 0, 0: 3}.items():
        bigram_rev[a, b] = np.log(0.99)
    initial_rev = np.log(np.full(W, 0.01 / (W - 1)))
    initial_rev[1] = np.log(0.99)
    g2 = compose_word_loop(vocab5, bigram_rev, lm_initial=initial_rev)
    final2, bps2 = token_passing(g2, log_b, n_best=1)
    _, words2, _ = backtrace_words(
        g2, np.asarray(final2), np.asarray(bps2), log_b.shape[0]
    )
    assert words2 == [1, 2, 0]


def test_insertion_penalty_discourages_word_breaks(vocab):
    """A large negative word-insertion penalty must not increase the number
    of decoded words, and drives the single-word hypothesis to win on
    ambiguous (flat) acoustics."""
    base = _word_model(0)
    W = 3
    vocab3 = stack_models([base.replace(word=f"w{i}") for i in range(W)])
    rng = np.random.default_rng(11)
    frames = np.concatenate([_sample_word(base, rng) for _ in range(2)])

    free = decode_continuous(
        vocab3, jnp.asarray(frames), exit_logprob=0.0, word_insertion_penalty=0.0
    )
    taxed = decode_continuous(
        vocab3,
        jnp.asarray(frames),
        exit_logprob=0.0,
        word_insertion_penalty=-1e4,
    )
    assert len(taxed[0][1]) <= len(free[0][1])
    assert len(taxed[0][1]) == 1


def test_block_engine_matches_dense(vocab):
    """The block-structured token passing (compose_word_loop_blocks +
    token_passing_blocks) must produce the same hypotheses and scores as
    the dense (S_tot K, S_tot) expansion, for unigram and bigram LMs and
    n_best > 1."""
    rng = np.random.default_rng(21)
    truth = [1, 3, 0, 2]
    frames = jnp.asarray(
        np.concatenate([_sample_word(_word_model(w), rng) for w in truth])
    )
    W = 5
    bigram = np.log(np.random.default_rng(5).dirichlet(np.ones(W), size=W))
    for lm, scale, pen in [
        (None, 1.0, 0.0),
        (bigram, 1.4, -0.6),
    ]:
        dense = decode_continuous(
            vocab, frames, lm_logprobs=lm, n_best=3,
            lm_scale=scale, word_insertion_penalty=pen, engine="dense",
        )
        blocks = decode_continuous(
            vocab, frames, lm_logprobs=lm, n_best=3,
            lm_scale=scale, word_insertion_penalty=pen, engine="blocks",
        )
        assert [h[1] for h in blocks] == [h[1] for h in dense]
        np.testing.assert_allclose(
            [h[0] for h in blocks], [h[0] for h in dense], rtol=1e-6
        )
        assert [h[2] for h in blocks] == [h[2] for h in dense]


def test_block_token_passing_matches_dense_lattice(vocab):
    """Raw lattice contract: scores AND backpointer-traced paths agree."""
    from srhmm_tpu.decode.continuous import (
        backtrace_path_device,
        compose_word_loop_blocks,
        token_passing_blocks,
    )

    rng = np.random.default_rng(8)
    truth = [4, 2]
    frames = jnp.asarray(
        np.concatenate([_sample_word(_word_model(w), rng) for w in truth])
    )
    graph_d = compose_word_loop(vocab)
    graph_b = compose_word_loop_blocks(vocab)
    log_b = composed_emissions(vocab, frames)

    fd, bpd = token_passing(graph_d, log_b, n_best=2)
    fb, bpb = token_passing_blocks(graph_b, log_b, n_best=2)
    np.testing.assert_allclose(np.asarray(fb), np.asarray(fd), rtol=1e-6)

    # device-side backtrace equals the host backtrace of the dense lattice
    T = log_b.shape[0]
    s_best = int(np.argmax(np.asarray(fd)[:, 0]))
    _, words_d, spans_d = backtrace_words(
        graph_d, np.asarray(fd), np.asarray(bpd), T
    )
    path_b = np.asarray(
        backtrace_path_device(bpb, jnp.asarray(s_best, jnp.int32), jnp.asarray(0, jnp.int32))
    )
    from srhmm_tpu.decode.continuous import _words_from_path

    words_b, spans_b = _words_from_path(path_b, vocab.trans.shape[-1])
    assert words_b == words_d
    assert spans_b == spans_d


def test_block_engine_scales_to_200_words():
    """W=200 word loop: the block engine decodes (sub-quadratic per-frame
    cost); the dense engine at this size would expand a (W S K, W S)
    matrix per frame."""
    W, S, D = 200, 3, 4
    models = [_word_model(i, S=S, D=D) for i in range(W)]
    vocab = stack_models(models)
    rng = np.random.default_rng(77)
    truth = [17, 181, 3]
    frames = jnp.asarray(
        np.concatenate([_sample_word(models[w], rng) for w in truth])
    )
    hyps = decode_continuous(vocab, frames, n_best=1)
    assert hyps[0][1] == truth


def _loop_utterances(vocab, rng, n_utts, n_words=3, D=None, noise=0.4):
    """Utterances that roughly follow the vocabulary's word models, so the
    decodes are non-trivial (continuous random emissions: no exact ties)."""
    W = vocab.trans.shape[0]
    S = vocab.trans.shape[-1]
    means = np.asarray(vocab.streams[0].means)
    D = means.shape[-1]
    utts = []
    for _ in range(n_utts):
        frames = []
        for w in rng.integers(0, W, size=n_words):
            for s in range(S):
                for _ in range(3 + int(rng.integers(0, 3))):
                    frames.append(means[w, s, 0] + noise * rng.normal(size=D))
        utts.append(np.asarray(frames))
    return utts


@pytest.mark.parametrize(
    "S,lm_kind,n_best",
    [
        (4, "unigram", 1),
        (8, "bigram", 1),
        (6, "bigram", 1),  # the reference trainer's own 6-state shape
        (4, "unigram", 2),
        (4, "bigram", 2),
        (4, "unigram", 3),
        (5, "bigram", 3),
        (4, "bigram", 4),
    ],
)
def test_batched_decode_matches_single(S, lm_kind, n_best):
    """decode_continuous_batch (the block engine vmapped over a padded
    batch, one batched backtrace) must reproduce decode_continuous on each
    utterance alone: identical word strings and spans, scores within the
    tolerance of srhmm_tpu.checks, for unigram and bigram LMs and
    n_best 1-4."""
    from srhmm_tpu.checks import compare_batched_decode
    from srhmm_tpu.io.dataset import pack_utterances

    rng = np.random.default_rng(3 * S + n_best)
    W, D = 5, 6
    vocab = stack_models([_word_model(i, S=S, D=D) for i in range(W)]).astype(
        jnp.float32
    )
    lm = (
        np.log(rng.dirichlet(np.ones(W), size=W)) if lm_kind == "bigram" else None
    )
    utts = _loop_utterances(vocab, rng, 3)
    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)
    out = compare_batched_decode(
        vocab, batch, range(len(utts)), n_best=n_best, lm_logprobs=lm
    )
    assert out["ok"], out


def test_decode_continuous_batch_k2_matches_single():
    """decode_continuous_batch(n_best=2) (flat-id batched backtrace) must
    reproduce decode_continuous's top-2 hypotheses per utterance."""
    import numpy as np

    from srhmm_tpu.decode.continuous import (
        decode_continuous,
        decode_continuous_batch,
    )
    from srhmm_tpu.io.dataset import pack_utterances
    from srhmm_tpu.models import stack_models

    rng = np.random.default_rng(9)
    W, S, D = 4, 4, 6
    vocab = stack_models([_word_model(i, S=S, D=D) for i in range(W)]).astype(
        jnp.float32
    )
    utts = []
    for b in range(3):
        frames = []
        for w in rng.integers(0, W, size=2):
            mu = np.asarray(vocab.streams[0].means)[w]
            for s in range(S):
                for _ in range(3 + int(rng.integers(0, 3))):
                    frames.append(mu[s, 0] + 0.4 * rng.normal(size=D))
        utts.append(np.asarray(frames))
    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)

    results = decode_continuous_batch(vocab, batch, n_best=2)
    for b, u in enumerate(utts):
        ref = decode_continuous(vocab, jnp.asarray(u, jnp.float32), n_best=2)
        hyps = results[b]
        assert len(hyps) >= 1
        for r, (score, words, spans) in enumerate(hyps[: len(ref)]):
            np.testing.assert_allclose(score, ref[r][0], rtol=2e-5, atol=1e-3)
            assert words == ref[r][1], (b, r, words, ref[r][1])


@pytest.mark.parametrize(
    "lm_kind,n_best", [("unigram", 1), ("bigram", 1), ("unigram", 2), ("bigram", 3)]
)
def test_batched_decode_full_cov(lm_kind, n_best):
    """FULL-covariance vocabularies (the reference's canonical covariance
    regime, T1:1834-1887) at the reference's own 6-state shape: the
    batched decoder matches the per-utterance engine."""
    from srhmm_tpu.checks import compare_batched_decode
    from srhmm_tpu.io.dataset import pack_utterances
    from srhmm_tpu.models import FULL

    rng = np.random.default_rng(17 + n_best)
    W, S, D, M = 5, 6, 4, 2

    def one(seed):
        r = np.random.default_rng(seed)
        means = r.normal(size=(S, M, D)) * 3.0
        a_rnd = r.normal(size=(S, M, D, D)) * 0.3
        cov = a_rnd @ np.swapaxes(a_rnd, -1, -2) + np.eye(D)[None, None]
        w = r.uniform(0.3, 0.7, size=(S, M))
        w /= w.sum(-1, keepdims=True)
        return GmmHmm(
            trans=init_left_right_trans(S),
            streams=(
                GmmStream(
                    weights=jnp.asarray(w),
                    means=jnp.asarray(means),
                    inv_cov=jnp.asarray(np.linalg.inv(cov)),
                    det=jnp.asarray(np.linalg.det(cov)),
                    cov_type=FULL,
                ),
            ),
            word=f"w{seed}",
        )

    vocab = stack_models([one(i) for i in range(W)]).astype(jnp.float32)
    utts = _loop_utterances(vocab, rng, 3)
    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)
    lm = np.log(rng.dirichlet(np.ones(W), size=W)) if lm_kind == "bigram" else None
    out = compare_batched_decode(
        vocab, batch, range(len(utts)), n_best=n_best, lm_logprobs=lm
    )
    assert out["ok"], out


def _two_stream_word(seed, S=3, D1=4, D2=3):
    """A 2-stream model: stream dims differ (the reference reads one
    feature file per stream, R2:331-339)."""
    rng = np.random.default_rng(seed)

    def stream(D, scale):
        means = rng.normal(size=(S, 1, D)) * scale
        var = np.full((S, 1, D), 1.0)
        return GmmStream(
            weights=jnp.ones((S, 1)),
            means=jnp.asarray(means),
            inv_cov=jnp.asarray(1.0 / var),
            det=jnp.asarray(np.prod(var, -1)),
            cov_type=DIAG,
        )

    return GmmHmm(
        trans=init_left_right_trans(S),
        streams=(stream(D1, 6.0), stream(D2, 5.0)),
        word=f"w{seed}",
    )


def test_multistream_decode_replicated_equals_single(vocab):
    """Round 5: multi-stream CONTINUOUS decode (XLA block engine).  A
    2-stream vocab whose streams are identical copies, fed the same
    frames per stream, must decode the same word string as the
    single-stream vocab with exactly doubled acoustic scores."""
    import jax

    rng = np.random.default_rng(3)
    truth = [1, 4, 2]
    frames = np.concatenate(
        [_sample_word(jax.tree.map(lambda a: a[w], vocab.replace(word="")), rng)
         for w in truth]
    )
    dup = vocab.replace(
        streams=(vocab.streams[0], vocab.streams[0]), word=vocab.word
    )
    single = decode_continuous(vocab, jnp.asarray(frames), n_best=1)[0]
    multi = decode_continuous(
        dup, (jnp.asarray(frames), jnp.asarray(frames)), n_best=1
    )[0]
    assert multi[1] == single[1] == truth
    # acoustic part doubles; LM/graph part stays -> just check decode agrees
    lb1 = np.asarray(composed_emissions(vocab, jnp.asarray(frames)))
    lb2 = np.asarray(
        composed_emissions(dup, (jnp.asarray(frames), jnp.asarray(frames)))
    )
    np.testing.assert_allclose(lb2, 2.0 * lb1, rtol=1e-5)


def test_multistream_decode_genuine_two_streams():
    """Genuine 2-stream decode with different per-stream dims: sampling
    both streams from word w's means must recover the word string, and a
    deliberately conflicting second stream must change the outcome (the
    second stream really participates)."""
    words = [_two_stream_word(i) for i in range(4)]
    vocab2 = stack_models(words)
    rng = np.random.default_rng(7)
    truth = [2, 0, 3]

    def sample(widx, stream_idx, wrong=None):
        mu = np.asarray(words[widx if wrong is None else wrong]
                        .streams[stream_idx].means)[:, 0]
        return np.concatenate(
            [mu[[s]] + 0.1 * rng.normal(size=(4, mu.shape[1])) for s in range(3)]
        )

    f1 = np.concatenate([sample(w, 0) for w in truth])
    f2 = np.concatenate([sample(w, 1) for w in truth])
    hyp = decode_continuous(
        vocab2, (jnp.asarray(f1), jnp.asarray(f2)), n_best=1
    )[0]
    assert hyp[1] == truth

    # batched entry point: tuple of UtteranceBatch per stream
    from srhmm_tpu.io.dataset import pack_utterances

    b1 = pack_utterances([f1], pad_multiple=8)
    b2 = pack_utterances([f2], pad_multiple=8)
    from srhmm_tpu.decode.continuous import decode_continuous_batch

    out = decode_continuous_batch(vocab2, (b1, b2), n_best=1)
    assert out[0][1] == truth

    # stream-2 evidence flipped to a different word on purpose: the joint
    # decode must NOT simply reproduce stream 1's string for that segment
    f2_conflict = np.concatenate(
        [sample(truth[0], 1, wrong=1), sample(truth[1], 1), sample(truth[2], 1)]
    )
    lb_match = np.asarray(
        composed_emissions(vocab2, (jnp.asarray(f1), jnp.asarray(f2)))
    )
    lb_conf = np.asarray(
        composed_emissions(vocab2, (jnp.asarray(f1), jnp.asarray(f2_conflict)))
    )
    assert not np.allclose(lb_match, lb_conf)


def test_multistream_fused_decode_matches_block_engine():
    """The batched decoder accepts per-stream batch tuples: its scores and
    word strings must match the block engine running on summed
    per-stream emissions, utterance by utterance."""
    from srhmm_tpu.decode.continuous import (
        compose_word_loop_blocks,
        decode_continuous_batch,
        token_passing_blocks,
    )
    from srhmm_tpu.io.dataset import pack_utterances

    words = [_two_stream_word(i) for i in range(4)]
    vocab2 = stack_models(words).astype(jnp.float32)
    rng = np.random.default_rng(31)
    utts1, utts2, truths = [], [], []
    for b in range(3):
        truth = rng.integers(0, 4, size=3).tolist()
        f1, f2 = [], []
        for w in truth:
            for s in range(3):
                n = 3 + int(rng.integers(0, 2))
                mu1 = np.asarray(words[w].streams[0].means)[s, 0]
                mu2 = np.asarray(words[w].streams[1].means)[s, 0]
                f1.append(mu1 + 0.1 * rng.normal(size=(n, 4)))
                f2.append(mu2 + 0.1 * rng.normal(size=(n, 3)))
        utts1.append(np.concatenate(f1))
        utts2.append(np.concatenate(f2))
        truths.append(truth)
    b1 = pack_utterances(utts1, pad_multiple=8, dtype=jnp.float32)
    b2 = pack_utterances(utts2, pad_multiple=8, dtype=jnp.float32)

    graph = compose_word_loop_blocks(vocab2)
    out = decode_continuous_batch(vocab2, (b1, b2), n_best=1)
    for b in range(3):
        frames = (jnp.asarray(utts1[b]), jnp.asarray(utts2[b]))
        log_b = composed_emissions(vocab2, frames)
        fx = np.asarray(token_passing_blocks(graph, log_b, n_best=1)[0])[:, 0]
        exits = np.arange(4) * 3 + 2
        np.testing.assert_allclose(out[b][0], fx[exits].max(), rtol=1e-5)
        assert out[b][1] == truths[b], (b, out[b][1], truths[b])


def test_multistream_kbest_decode_matches_single_utterance():
    """Multi-stream n_best>=2: the batched hypotheses must match the
    per-utterance engine."""
    from srhmm_tpu.decode.continuous import (
        decode_continuous,
        decode_continuous_batch,
    )
    from srhmm_tpu.io.dataset import pack_utterances

    words = [_two_stream_word(i) for i in range(4)]
    vocab2 = stack_models(words).astype(jnp.float32)
    rng = np.random.default_rng(41)
    utts1, utts2 = [], []
    for b in range(2):
        truth = rng.integers(0, 4, size=2).tolist()
        f1, f2 = [], []
        for w in truth:
            for s in range(3):
                mu1 = np.asarray(words[w].streams[0].means)[s, 0]
                mu2 = np.asarray(words[w].streams[1].means)[s, 0]
                f1.append(mu1 + 0.1 * rng.normal(size=(4, 4)))
                f2.append(mu2 + 0.1 * rng.normal(size=(4, 3)))
        utts1.append(np.concatenate(f1))
        utts2.append(np.concatenate(f2))
    b1 = pack_utterances(utts1, pad_multiple=8, dtype=jnp.float32)
    b2 = pack_utterances(utts2, pad_multiple=8, dtype=jnp.float32)

    for K in (2, 3):
        got = decode_continuous_batch(
            vocab2, (b1, b2), n_best=K
        )
        for b in range(2):
            ref = decode_continuous(
                vocab2,
                (jnp.asarray(utts1[b]), jnp.asarray(utts2[b])),
                n_best=K,
            )
            for (rs, rw, _), (gs, gw, _) in zip(ref, got[b]):
                assert gw == rw, (K, b, gw, rw)
                np.testing.assert_allclose(gs, rs, rtol=2e-5, atol=1e-3)


def test_heterogeneous_word_lengths_decode():
    """Round 5: words of DIFFERENT state counts decode through the
    word-loop engines — pad_stack_models supplies per-word final states,
    the graph carries them, and boundaries are detected at each word's
    REAL exit.  Truth recovery + per-utterance == batched."""
    from srhmm_tpu.decode.continuous import (
        decode_continuous,
        decode_continuous_batch,
    )
    from srhmm_tpu.io.dataset import pack_utterances
    from srhmm_tpu.models import pad_stack_models

    rng = np.random.default_rng(47)
    lens = [3, 5, 4, 3]  # states per word — heterogeneous
    words = [_word_model(100 + i, S=lens[i], D=4) for i in range(4)]
    vocab, finals = pad_stack_models(words)
    vocab = vocab.astype(jnp.float32)
    S_pad = vocab.trans.shape[-1]
    assert S_pad == max(lens)

    utts, truths = [], []
    for b in range(3):
        truth = rng.integers(0, 4, size=3).tolist()
        frames = []
        for w in truth:
            mu = np.asarray(words[w].streams[0].means)[:, 0]
            for st in range(lens[w]):
                for _ in range(4):
                    frames.append(mu[st] + 0.1 * rng.normal(size=4))
        utts.append(np.asarray(frames))
        truths.append(truth)

    fn = np.asarray(finals)
    for b in range(3):
        hyp = decode_continuous(
            vocab, jnp.asarray(utts[b], jnp.float32), n_best=1,
            final_states=fn,
        )[0]
        assert hyp[1] == truths[b], (b, hyp[1], truths[b])

    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)
    out = decode_continuous_batch(
        vocab, batch, n_best=1, final_states=fn
    )
    for b in range(3):
        assert out[b][1] == truths[b], (b, out[b][1], truths[b])
        ref = decode_continuous(
            vocab, jnp.asarray(utts[b], jnp.float32), n_best=1,
            final_states=fn,
        )[0]
        np.testing.assert_allclose(out[b][0], ref[0], rtol=2e-5, atol=1e-3)

    # K-best: batched == per-utterance, word strings and scores
    out2 = decode_continuous_batch(
        vocab, batch, n_best=2, final_states=fn
    )
    for b in range(3):
        ref2 = decode_continuous(
            vocab, jnp.asarray(utts[b], jnp.float32), n_best=2,
            final_states=fn,
        )
        for (rs, rw, _), (gs, gw, _) in zip(ref2, out2[b]):
            assert gw == rw, (b, gw, rw)
            np.testing.assert_allclose(gs, rs, rtol=2e-5, atol=1e-3)
