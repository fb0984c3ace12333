"""Production CLI for the beyond-reference trainers: embedded and tied EM.

The reference gives its one (isolated-word) trainer a CLI and a resumable
model write (main T1:106-208, writing_model T1:2286); this gives the same
production surface to the embedded (unit-inventory) and tied-state
(senone) trainers that the reference lacks entirely:

    python -m srhmm_tpu.cli.train_embedded TRANSCRIPTS OUTPUT_DIR
        [--states S] [--mix M] [--cov diag|full]
        [--tied] [--max-senones N] [--min-gain X] [--min-occ X]
        [--init DIR] [--threshold X] [--max-iters N] [--chunk K]
        [--checkpoint-dir D] [--data-parallel N] [--pad-multiple N]

TRANSCRIPTS: text file, one training utterance per line:

    path/to/features.perfil unit_a unit_b unit_c ...

Unit names of the form `left-center+right` are parsed as triphones (the
HTK-style convention), which enables `--tied` decision-tree clustering
across contexts; any other name is its own context-free unit.

Without --tied: embedded EM over the unit inventory (train/embedded.py);
OUTPUT_DIR gets one
reference-compatible `<unit>.hmm` per unit plus `summary.json`.

With --tied: monophone-cloned triphone seeding is assumed done by the
caller (units ARE the inventory); per-(unit,state) occupancy statistics
from one embedded E-step feed the phonetic decision tree
(models/decision_tree.py), the tied system trains with
train/tied.train_tied, and OUTPUT_DIR
gets the materialized per-unit `.hmm` files plus `senone_map.json`
(unit -> senone ids) and `summary.json`.

--checkpoint-dir enables chunk-granular checkpoint/resume through the
chunked convergence driver for BOTH trainers: a killed run re-invoked
with the same command line resumes from the newest complete checkpoint
with the identical trajectory.
--data-parallel N trains on an N-device data mesh (shard_map scan).
--init DIR warm-starts each unit from DIR/<unit>.hmm instead of the LBG
flat start (the reference's documented-but-broken warm start, T1:204,
works here).

Datasets beyond device memory: the isolated trainer's --stream-shards
double-buffered pipeline is not wired here (the composed trainers keep
all shape buckets device-resident for the single-scan design); shard the
transcript file and chain invocations with --init + --checkpoint-dir
instead — EM over a corpus partition with warm start is the standard
large-corpus recipe.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def read_transcripts(path: str):
    """[(perfil_path, [unit names...])] from the transcript file."""
    items = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"transcript line needs a path and units: {line!r}")
        items.append((parts[0], parts[1:]))
    return items


def parse_triphone(name: str):
    """`l-c+r` -> (l, c, r); bare names -> ('', name, '')."""
    if "-" in name and "+" in name and name.index("-") < name.index("+"):
        left, rest = name.split("-", 1)
        center, right = rest.split("+", 1)
        return (left, center, right)
    return ("", name, "")


def flat_start_units(
    unit_names, feats, transcripts, states: int, mix: int, cov: str
):
    """LBG flat start for an arbitrary unit inventory: uniform segmentation
    of each utterance over its transcript positions, per-unit LBG init
    (the pipeline.flat_start_monophones scheme generalized)."""
    import numpy as np

    from ..init.lbg import create_initial_model
    from ..models import stack_models

    segments = {u: [] for u in unit_names}
    for f, seq in zip(feats, transcripts):
        bounds = np.linspace(0, len(f), len(seq) + 1).astype(int)
        for k, u in enumerate(seq):
            seg = f[bounds[k] : bounds[k + 1]]
            if len(seg) >= states:
                segments[u].append(np.asarray(seg, np.float64))
    models = []
    for u in unit_names:
        if not segments[u]:
            raise SystemExit(f"unit {u!r} has no usable training segments")
        models.append(
            create_initial_model(
                [segments[u]], states, [mix], word=u, cov_type=cov
            )
        )
    return stack_models(models)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("transcripts")
    ap.add_argument("output_dir")
    ap.add_argument("--states", type=int, default=3)
    ap.add_argument("--mix", type=int, default=2)
    ap.add_argument("--cov", choices=["diag", "full"], default="diag")
    ap.add_argument("--tied", action="store_true")
    ap.add_argument("--max-senones", type=int, default=None)
    ap.add_argument("--min-gain", type=float, default=200.0)
    ap.add_argument("--min-occ", type=float, default=40.0)
    ap.add_argument("--init", default=None, metavar="DIR")
    ap.add_argument("--threshold", type=float, default=1.0e-3)
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--data-parallel", type=int, default=None, metavar="N")
    ap.add_argument("--pad-multiple", type=int, default=32)
    ap.add_argument(
        "--var-floor", type=float, default=0.0,
        help="relative variance floor on top of the reference's absolute "
        "1e-5 (recommended ~1e-3 of the feature variance scale; see "
        "pipeline.run_pipeline's CMVN note)",
    )
    ap.add_argument("--size-t-width", type=int, default=4)
    ap.add_argument(
        "--scan-iters", type=int, default=None, metavar="N",
        help="fixed-budget mode: run exactly N EM iterations as one "
        "device-side scan, skipping the reference convergence rule "
        "(cli/train.py --scan-iters for the composed trainers)",
    )
    ap.add_argument(
        "--cmvn", choices=["off", "global"], default="off",
        help="train in globally mean/variance-normalized feature space and "
        "de-normalize the exported models (the f32-precision lever; EM is "
        "exactly affine-equivariant, cli/train.py --cmvn)",
    )
    ns = ap.parse_args(argv)

    from ..ops.backend import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..io import read_hmm, read_perfil, write_hmm
    from ..models import stack_models

    t0 = time.time()
    items = read_transcripts(ns.transcripts)
    unit_names = sorted({u for _, seq in items for u in seq})
    uidx = {u: i for i, u in enumerate(unit_names)}
    feats = [np.asarray(read_perfil(p), np.float32) for p, _ in items]
    transcripts_named = [seq for _, seq in items]
    transcripts = [[uidx[u] for u in seq] for seq in transcripts_named]

    cmvn_stats = None
    lp_offset = 0.0
    if ns.cmvn == "global":
        allf = np.concatenate([np.asarray(f, np.float64) for f in feats], 0)
        g_mean = allf.mean(0)
        g_std = np.maximum(allf.std(0), 1e-8)
        # constant Jacobian correction applied INSIDE the convergence rule
        # (the reference's relative-change test is not shift-invariant;
        # cli/train.py --cmvn)
        lp_offset = -float(sum(len(f) for f in feats) * np.log(g_std).sum())
        feats = [((f - g_mean) / g_std).astype(np.float32) for f in feats]
        cmvn_stats = (g_mean, g_std)

    if ns.init:
        models = stack_models(
            [
                read_hmm(str(Path(ns.init) / f"{u}.hmm")).replace(word=u)
                for u in unit_names
            ]
        )
    else:
        models = flat_start_units(
            unit_names, feats, transcripts_named, ns.states, ns.mix, ns.cov
        )
    models = models.astype(jnp.float32)

    mesh = None
    if ns.data_parallel:
        from ..parallel.mesh import make_mesh

        if len(jax.devices()) < ns.data_parallel:
            print(
                f"--data-parallel {ns.data_parallel}: only "
                f"{len(jax.devices())} devices",
                file=sys.stderr,
            )
            return 1
        mesh = make_mesh(
            n_data=ns.data_parallel, n_model=1,
            devices=jax.devices()[: ns.data_parallel],
        )

    out_dir = Path(ns.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {
        "units": unit_names,
        "n_utterances": len(items),
        "states": ns.states,
        "mix": ns.mix,
        "cov": ns.cov,
    }

    if ns.tied:
        from ..models.decision_tree import (
            cluster_states,
            state_stats_from_suffstats,
        )
        from ..models.tying import tie_from_models
        from ..pipeline import _bucketed_embedded_stats
        from ..train.tied import train_tied

        tris = [parse_triphone(u) for u in unit_names]
        stats = _bucketed_embedded_stats(
            models, feats, transcripts, pad_multiple=ns.pad_multiple
        )
        occ, x, xx = state_stats_from_suffstats(stats)
        cluster = cluster_states(
            tris, occ, x, xx,
            min_occ=ns.min_occ, min_gain=ns.min_gain,
            max_senones=ns.max_senones,
        )
        tied0 = tie_from_models(models, cluster.state_map).astype(jnp.float32)
        threshold, max_iters, chunk = (
            (-1.0, ns.scan_iters, ns.scan_iters)
            if ns.scan_iters
            else (ns.threshold, ns.max_iters, ns.chunk)
        )
        res = train_tied(
            tied0, feats, transcripts,
            threshold=threshold, max_iterations=max_iters,
            var_floor=ns.var_floor, log_prob_offset=lp_offset,
            pad_multiple=ns.pad_multiple, chunk=chunk, mesh=mesh,
            checkpoint_dir=ns.checkpoint_dir,
        )
        trained = res.model
        unit_models = trained.materialize()
        state_map = np.asarray(trained.state_map)
        summary.update(
            n_senones=int(trained.num_senones),
            senone_map_file="senone_map.json",
        )
        (out_dir / "senone_map.json").write_text(
            json.dumps(
                {u: state_map[i].tolist() for i, u in enumerate(unit_names)}
            )
        )
    else:
        from ..train.embedded import train_embedded

        threshold, max_iters, chunk = (
            (-1.0, ns.scan_iters, ns.scan_iters)
            if ns.scan_iters
            else (ns.threshold, ns.max_iters, ns.chunk)
        )
        res = train_embedded(
            models, feats, transcripts,
            threshold=threshold, max_iterations=max_iters,
            var_floor=ns.var_floor, log_prob_offset=lp_offset,
            pad_multiple=ns.pad_multiple, chunk=chunk, mesh=mesh,
            checkpoint_dir=ns.checkpoint_dir,
        )
        unit_models = res.model

    if cmvn_stats is not None:
        # back to raw feature space (exact inverse affine; the reported
        # probabilities already carry the Jacobian offset)
        from ..models.gmm_hmm import denormalize_model

        unit_models = denormalize_model(unit_models, [cmvn_stats])

    # export: one reference-compatible .hmm per unit, float64 file contract
    def unit_slice(i: int):
        take = lambda a: jnp.asarray(np.asarray(a, np.float64)[i])
        m = jax.tree.map(take, unit_models.replace(word=""))
        streams = tuple(
            s.replace(
                det=jnp.exp(s.log_abs_det()) if s.log_det is not None else s.det,
                log_det=None,
            )
            for s in m.streams
        )
        return m.replace(streams=streams, word=unit_names[i])

    for i, u in enumerate(unit_names):
        write_hmm(
            str(out_dir / f"{u}.hmm"), unit_slice(i),
            size_t_width=ns.size_t_width,
        )

    summary.update(
        iterations=res.iterations,
        mean_log_prob=float(res.mean_log_prob),
        wall_seconds=round(time.time() - t0, 2),
        tied=bool(ns.tied),
    )
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
