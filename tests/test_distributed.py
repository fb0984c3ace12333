"""Two-process jax.distributed smoke test (SURVEY §4 multi-host plan).

The reference is strictly single-process (no MPI/NCCL/sockets anywhere,
T1:25-33); our multi-host story is jax.distributed + GSPMD collectives.
Real multi-host needs several machines; here TWO LOCAL PROCESSES each expose
4 forced host-platform CPU devices and initialize through
`parallel.distributed.initialize` with an explicit coordinator, giving an
8-device global mesh whose all-reduces cross the process boundary over the
distributed runtime — the same code path several hosts use.  Each process computes a psum'd
E-step on its process-local batch shard; the coordinator asserts equality
with the single-process result.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import json, os, sys

import jax

from srhmm_tpu.parallel import distributed

proc_id = int(sys.argv[1])
port = sys.argv[2]
distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=2,
    process_id=proc_id,
    local_device_ids=list(range(4)),
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()

import jax.numpy as jnp
import numpy as np

from jax.sharding import NamedSharding, PartitionSpec as P

from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans
from srhmm_tpu.parallel.mesh import make_mesh
from srhmm_tpu.train.em import e_step

S, M, D, B, T = 4, 2, 6, 16, 40
rng = np.random.default_rng(0)
var = rng.uniform(0.5, 1.5, size=(S, M, D))
w = rng.uniform(0.3, 0.7, size=(S, M))
w /= w.sum(-1, keepdims=True)
model = GmmHmm(
    trans=init_left_right_trans(S),
    streams=(
        GmmStream(
            weights=jnp.asarray(w),
            means=jnp.asarray(rng.normal(size=(S, M, D)) * 2.0),
            inv_cov=jnp.asarray(1.0 / var),
            det=jnp.asarray(np.prod(var, -1)),
            cov_type=DIAG,
        ),
    ),
).astype(jnp.float32)
utts = [rng.normal(size=(30 + i, D)) for i in range(B)]
batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)

mesh = make_mesh(n_data=8, n_model=1)
# global batch assembled from per-process host-local shards
n_local = B // jax.process_count()
lo = proc_id * n_local
sharding = NamedSharding(mesh, P("data", None, None))
feats = jax.make_array_from_process_local_data(
    sharding, np.asarray(batch.features)[lo : lo + n_local]
)
lens = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), np.asarray(batch.lengths)[lo : lo + n_local]
)
gbatch = batch.replace(features=feats, lengths=lens)
model_r = jax.device_put(model, NamedSharding(mesh, P()))
stats = e_step(model_r, gbatch)
out = {
    "log_prob": float(stats.log_prob),
    "num_valid": float(stats.num_valid),
    "den_mix": np.asarray(stats.den_mix).tolist(),
}
if distributed.is_coordinator():
    print("RESULT " + json.dumps(out))
"""


def test_two_process_distributed_psum(tmp_path):
    """2 processes x 4 forced-host devices: the distributed-runtime E-step
    equals the single-process one."""
    if sys.platform != "linux":
        pytest.skip("linux only")
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", ""
        )
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=str(tmp_path),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        if rc != 0 and (
            "UNIMPLEMENTED" in err or "distributed" in err and "support" in err
        ):
            pytest.skip(f"jax.distributed unsupported here: {err[-200:]}")
        assert rc == 0, err[-2000:]
    result = None
    for rc, out, err in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
    assert result is not None, outs[0][1]

    # single-process reference (this process: 8 virtual devices, no
    # distributed runtime)
    import jax
    import jax.numpy as jnp

    from srhmm_tpu.io.dataset import pack_utterances
    from srhmm_tpu.models import DIAG, GmmHmm, GmmStream, init_left_right_trans
    from srhmm_tpu.train.em import e_step

    S, M, D, B = 4, 2, 6, 16
    rng = np.random.default_rng(0)
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    model = GmmHmm(
        trans=init_left_right_trans(S),
        streams=(
            GmmStream(
                weights=jnp.asarray(w),
                means=jnp.asarray(rng.normal(size=(S, M, D)) * 2.0),
                inv_cov=jnp.asarray(1.0 / var),
                det=jnp.asarray(np.prod(var, -1)),
                cov_type=DIAG,
            ),
        ),
    ).astype(jnp.float32)
    utts = [rng.normal(size=(30 + i, D)) for i in range(B)]
    batch = pack_utterances(utts, pad_multiple=8, dtype=jnp.float32)
    ref = e_step(model, batch)

    np.testing.assert_allclose(
        result["log_prob"], float(ref.log_prob), rtol=1e-5
    )
    assert result["num_valid"] == float(ref.num_valid)
    np.testing.assert_allclose(
        np.asarray(result["den_mix"]), np.asarray(ref.den_mix), rtol=1e-4,
        atol=1e-5,
    )
