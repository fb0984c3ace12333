"""Multi-host bootstrap.

The reference has no distributed communication at all (SURVEY §2.4).  With
several hosts (or several processes on one host), each process runs the
same program; `initialize()` wires up the jax.distributed runtime so
`jax.devices()` spans every process and the mesh helpers in
parallel/mesh.py build global meshes.  Collectives are emitted by XLA from
the sharding annotations (NCCL between GPUs); there is no user-level
messaging to manage.

Typical multi-process training loop:

    from srhmm_tpu.parallel import distributed, make_mesh, shard_batch, shard_model
    distributed.initialize(coordinator_address="host0:1234",
                           num_processes=2, process_id=rank)
    mesh = make_mesh(n_model=2)                   # global (data, model) mesh
    model = shard_model(model, mesh)
    batch = shard_batch(host_local_batch, mesh)   # per-host shard of the batch
    new_model, lp, nv = em_step(model, batch)     # all-reduced stats
    if distributed.is_coordinator():
        checkpoint_manager.save(new_model, state)
"""

from __future__ import annotations

import os

import jax


def initialize(**kwargs) -> None:
    """jax.distributed.initialize with an explicit cluster, skipped when no
    coordinator is given (single process) or when already initialized.
    The coordinator comes from the kwargs (coordinator_address,
    num_processes, process_id, ...) or from JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID; nothing is discovered implicitly.

    MUST be called before any device/backend query: probing
    jax.process_count() (or jax.devices()) initializes the local backend
    and poisons distributed startup — the original wrapper did exactly
    that and silently swallowed the resulting error, leaving every
    "multi-host" run secretly single-process (caught by
    tests/test_distributed.py's two-process smoke test)."""
    state = getattr(jax.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # already initialized
    env = {
        "coordinator_address": os.environ.get("JAX_COORDINATOR_ADDRESS"),
        "num_processes": os.environ.get("JAX_NUM_PROCESSES"),
        "process_id": os.environ.get("JAX_PROCESS_ID"),
    }
    for key, value in env.items():
        if value is not None and key not in kwargs:
            kwargs[key] = value if key == "coordinator_address" else int(value)
    if kwargs.get("coordinator_address") is None:
        return  # single process
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # re-init is benign; real failures propagate
        if "already" not in str(e).lower():
            raise


def is_coordinator() -> bool:
    return jax.process_index() == 0
