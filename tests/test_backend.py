"""The per-platform implementation choice (ops/backend.py), with the
platform monkeypatched: XLA on the CPU, the kernel on a GPU, never the
interpreter on a GPU, an error where a kernel cannot run; and the
persistent compile cache location."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srhmm_tpu.ops import backend


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")


def test_cpu_picks_xla():
    assert backend.platform() == "cpu"
    assert backend.lattice_impl() == backend.XLA
    assert backend.lattice_impl(jnp.zeros((4, 3))) == backend.XLA


def test_gpu_picks_kernel_for_local_inputs(on_gpu):
    assert backend.lattice_impl() == backend.TRITON
    assert backend.lattice_impl(jnp.zeros((4, 3))) == backend.TRITON


def test_gpu_keeps_gspmd_sharded_inputs_on_xla(on_gpu):
    """A pallas_call cannot be partitioned by GSPMD: arrays laid out over
    several devices take the XLA path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from srhmm_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    x = jax.device_put(jnp.zeros((8, 3)), NamedSharding(mesh, P("data", None)))
    assert backend.lattice_impl(x) == backend.XLA


def test_interpreter_refused_on_gpu(on_gpu):
    with pytest.raises(RuntimeError, match="interpret"):
        backend.check_kernel_runnable(interpret=True)
    backend.check_kernel_runnable(interpret=False)


def test_compiled_kernel_refused_off_gpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        backend.check_kernel_runnable(interpret=False)
    backend.check_kernel_runnable(interpret=True)


def test_forcing_the_kernel_on_cpu_raises():
    """Forcing the Triton lattice where it cannot compile is an error, not
    a silent fallback to the interpreter or to XLA."""
    from srhmm_tpu.ops.lattice_triton import forward_lattice

    lb = jnp.zeros((5, 2, 3), jnp.float32)
    lt = jnp.zeros((2, 2), jnp.float32)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        forward_lattice(lb, lt, jnp.full((3,), 5, jnp.int32))


def test_default_device_decides_the_platform():
    """Work placed on the CPU with jax.default_device runs the CPU's
    implementation (the in-process host reference of chip_smoke.py)."""
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend.platform() == "cpu"
        assert backend.lattice_impl() == backend.XLA


def test_cpu_defaults_equal_the_xla_paths():
    """On the CPU the production entry points ARE the XLA paths: e_step
    and score_batch equal their explicit XLA forms bit for bit."""
    from srhmm_tpu.bench.suite import _rand_model
    from srhmm_tpu.decode.scorer import score_batch, score_batch_log
    from srhmm_tpu.models import stack_models
    from srhmm_tpu.train.em import e_step

    rng = np.random.default_rng(0)
    model = _rand_model(rng, 4, 2, 3, jnp.float32)
    feats = jnp.asarray(rng.normal(size=(5, 12, 3)), jnp.float32)
    from srhmm_tpu.io.dataset import UtteranceBatch

    batch = UtteranceBatch(features=feats, lengths=jnp.asarray([12, 9, 12, 4, 7]))
    for a, b in zip(
        jax.tree.leaves(e_step(model, batch)),
        jax.tree.leaves(e_step(model, batch, lattice="xla")),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    vocab = stack_models([model.replace(word="a"), model.replace(word="b")])
    np.testing.assert_array_equal(
        np.asarray(score_batch(vocab, batch)),
        np.asarray(score_batch_log(vocab, batch)),
    )


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_the_environment(
    monkeypatch, tmp_path, restore_cache_dir
):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_inside_the_checkout(
    monkeypatch, restore_cache_dir
):
    from pathlib import Path

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_compile_cache()
    repo = Path(__file__).resolve().parent.parent
    assert path == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
