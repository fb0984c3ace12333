"""Forced-alignment CLI: Viterbi-align transcripts to feature files.

Usage:
    python -m srhmm_tpu.cli.align MODEL_LIST TRANSCRIPTS OUTPUT
        [--frame-shift MS]

MODEL_LIST: list file of .hmm paths (the unit/word inventory, stacked by
name order of appearance); TRANSCRIPTS: one utterance per line,
`path/to/features.perfil unit_a unit_b ...` (the cli/train_embedded
contract).  OUTPUT receives, per utterance, one line per transcript unit:

    <perfil>  <unit>  <start_frame>  <end_frame>  [<start_s> <end_s>]

with times included when --frame-shift (milliseconds) is given.
Alignment is the Viterbi best path through the left-to-right
concatenation of the transcript's unit models (compose_sequence — the
same graph embedded re-estimation trains over), ending in the final
unit's exit state.  The reference has no alignment program at all
(isolated-word scoring only, R2:341-369); this is the standard
segmentation tool a phone-based system needs.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_list")
    ap.add_argument("transcripts")
    ap.add_argument("output_file")
    ap.add_argument(
        "--frame-shift", type=float, default=None, metavar="MS",
        help="frame shift in milliseconds; adds start/end seconds columns",
    )
    ns = ap.parse_args(argv)

    from ..ops.backend import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from .train_embedded import read_transcripts
    from ..decode.continuous import (
        backtrace_words,
        compose_sequence,
        emissions_for_graph,
        token_passing,
    )
    from ..io import read_perfil, read_vocabulary
    from ..models import stack_models

    models = read_vocabulary(ns.model_list)
    names = [m.word for m in models]
    uidx = {n: i for i, n in enumerate(names)}
    vocab = stack_models(models).astype(jnp.float32)

    items = read_transcripts(ns.transcripts)
    shift_s = ns.frame_shift / 1000.0 if ns.frame_shift else None
    n_fail = 0
    with open(ns.output_file, "w") as out:
        for path, seq in items:
            missing = [u for u in seq if u not in uidx]
            if missing:
                raise SystemExit(f"{path}: unknown units {missing}")
            ids = [uidx[u] for u in seq]
            frames = jnp.asarray(
                np.asarray(read_perfil(path), np.float32)
            )
            graph = compose_sequence(vocab, ids)
            log_b = emissions_for_graph(vocab, graph, frames)
            final, bps = token_passing(graph, log_b, n_best=1)
            # FORCE the end at the last transcript unit's exit state (the
            # forced-alignment contract; backtrace_words alone would pick
            # the best exit of ANY position)
            fin = np.asarray(final)
            exit_last = int(np.asarray(graph.exit_states)[-1])
            masked = np.full_like(fin, -np.inf)
            masked[exit_last] = fin[exit_last]
            score, units, spans = backtrace_words(
                graph, masked, np.asarray(bps), log_b.shape[0]
            )
            if not np.isfinite(score) or units != ids:
                # the best full-transcript path must traverse every unit;
                # a mismatch means the utterance cannot realize the
                # transcript (too few frames / -inf emissions)
                out.write(f"{path}\tALIGNMENT-FAILED\n")
                n_fail += 1
                continue
            for u, (a, b) in zip(seq, spans):
                line = f"{path}\t{u}\t{a}\t{b}"
                if shift_s is not None:
                    line += f"\t{a * shift_s:.3f}\t{b * shift_s:.3f}"
                out.write(line + "\n")
    if n_fail:
        print(f"{n_fail}/{len(items)} utterances failed to align", file=sys.stderr)
    return 0 if n_fail == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
