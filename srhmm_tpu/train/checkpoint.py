"""Checkpoint / resume / failure recovery.

The reference's only checkpoint is the final `.hmm` write, and its documented
warm-start flag is broken (argv[argc] off-by-one, T1:204) — a crash mid-EM
loses everything, and there is no failure detection at all (SURVEY §5).

Here every EM iteration can be checkpointed.  Two formats:

* **reference-compatible `.hmm`** (io/hmm_format.py) — interchange with the
  C programs, final-model export;
* **native checkpoint** — the model pytree's flattened leaves as a numpy
  `.npz`, restored against a template of the same structure, plus a JSON
  sidecar holding the EM driver state (iteration, last log prob, convergence
  bookkeeping), so a restarted job resumes mid-training with identical
  subsequent iterations.  EM is restartable at iteration granularity because
  the model is the complete driver state (stats are recomputed each pass).

`CheckpointManager.latest()` implements the recovery protocol: scan the
directory, pick the newest complete checkpoint (write is atomic via
tmp+rename), resume.  Multi-host: every host computes identical replicated
models, so host 0 writes and others skip (`should_write`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np

from ..models.gmm_hmm import GmmHmm


@dataclass
class EmDriverState:
    iteration: int
    old_log_prob: float
    history: list


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _paths(self, iteration: int) -> tuple[Path, Path]:
        return (
            self.dir / f"ckpt_{iteration:06d}.npz",
            self.dir / f"ckpt_{iteration:06d}.json",
        )

    @staticmethod
    def should_write() -> bool:
        return jax.process_index() == 0

    def save(self, model: GmmHmm, state: EmDriverState) -> None:
        if not self.should_write():
            return
        mp, js = self._paths(state.iteration)
        meta = {
            "iteration": state.iteration,
            "old_log_prob": state.old_log_prob,
            "history": state.history,
            # model-identity fields are best-effort: the manager handles any
            # trainer-state pytree (GmmHmm, stacked vocab, TiedHmmSet)
            "word": str(getattr(model, "word", "")),
            "cov_types": [
                s.cov_type for s in getattr(model, "streams", ())
            ],
        }
        tmp = mp.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, *(np.asarray(x) for x in jax.tree.leaves(model)))
        os.replace(tmp, mp)  # atomic: .json presence marks completeness
        tmp_j = js.with_suffix(".jtmp")
        tmp_j.write_text(json.dumps(meta))
        os.replace(tmp_j, js)
        self._gc()

    def _gc(self):
        done = sorted(self.dir.glob("ckpt_*.json"))
        for js in done[: -self.keep]:
            js.with_suffix(".npz").unlink(missing_ok=True)
            js.unlink(missing_ok=True)

    def latest(self, template: GmmHmm) -> tuple[GmmHmm, EmDriverState] | None:
        """Newest complete checkpoint, deserialized against `template`'s
        structure (shapes/cov types must match the run config)."""
        done = sorted(self.dir.glob("ckpt_*.json"))
        for js in reversed(done):
            mp = js.with_suffix(".npz")
            if not mp.exists():
                continue
            meta = json.loads(js.read_text())
            model = _restore(template, mp)
            return model, EmDriverState(
                iteration=meta["iteration"],
                old_log_prob=meta["old_log_prob"],
                history=meta["history"],
            )
        return None


def _restore(template, path: Path):
    """Leaves from an .npz written by save, unflattened into template's
    tree structure (numpy arrays, dtypes as saved)."""
    want, treedef = jax.tree.flatten(template)
    with np.load(path) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    if len(leaves) != len(want) or any(
        a.shape != np.shape(b) for a, b in zip(leaves, want)
    ):
        raise ValueError(
            f"checkpoint {path} does not match the template's structure"
        )
    return jax.tree.unflatten(treedef, leaves)


def train_fast_resumable(
    model: GmmHmm,
    batch,
    ckpt_dir: str | Path,
    threshold: float = 1.0e-3,
    max_iterations: int = 100,
    var_floor: float = 0.0,
    log_prob_offset: float = 0.0,
):
    """train_fast with per-iteration checkpointing and automatic resume.

    Crash-and-restart at any point continues from the last completed
    iteration with the identical trajectory (EM state == model + scalar
    bookkeeping)."""
    from .em import em_step
    from .em_parity import TrainResult

    mgr = CheckpointManager(ckpt_dir)
    state = EmDriverState(iteration=0, old_log_prob=1.0, history=[])
    resumed = mgr.latest(model)
    if resumed is not None:
        model, state = resumed

    n_valid = batch.batch_size
    while state.iteration < max_iterations:
        state.iteration += 1
        new_model, log_prob, num_valid = em_step(model, batch, var_floor)
        log_prob = float(log_prob) + log_prob_offset
        n_valid = int(num_valid)
        state.history.append(log_prob)
        if state.old_log_prob != 0.0 and (
            abs((state.old_log_prob - log_prob) / state.old_log_prob) <= threshold
        ):
            mgr.save(model, state)
            break
        state.old_log_prob = log_prob
        model = new_model
        mgr.save(model, state)
    return TrainResult(
        model=model,
        iterations=state.iteration,
        mean_log_prob=state.history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=state.history,
    )
