"""Checks that only mean something on the card: the compiled Triton
lattice kernels and the paths built on them against their XLA forms
(srhmm_tpu.checks), at moderate widths.  They skip on the CPU; on a GPU
machine `chip_smoke.py` runs the same checks at full widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernels compile only for the card")


def _batch(rng, B, T, D):
    from srhmm_tpu.io.dataset import pack_utterances

    return pack_utterances(
        [rng.normal(size=(T - (i % 7), D)) * 2.0 for i in range(B)],
        pad_multiple=8, dtype=jnp.float32,
    )


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_compiled_e_step_matches_xla(gpu, cov):
    from srhmm_tpu.bench.suite import recognition_vocab
    from srhmm_tpu.checks import compare_e_step

    model = jax.tree.map(lambda a: a[0], recognition_vocab(cov).replace(word=""))
    out = compare_e_step(model, _batch(np.random.default_rng(0), 256, 200, 9))
    assert out["ok"], out


@pytest.mark.parametrize("mode", ["total", "final"])
def test_compiled_scores_match_xla(gpu, mode):
    from srhmm_tpu.bench.suite import recognition_vocab
    from srhmm_tpu.checks import compare_scores

    out = compare_scores(
        recognition_vocab("full"), _batch(np.random.default_rng(1), 256, 200, 9),
        mode=mode,
    )
    assert out["ok"], out
