"""Continuous recognition CLI: word-loop token-passing decode with N-best.

Usage:
    python -m srhmm_tpu.cli.decode model_list input_list output_file
        [--n-best K] [--exit-logprob X] [--ref ref_file]
        [--lm lm_file] [--lm-scale S] [--word-penalty P] [--batch]

model_list: list file of .hmm paths (the vocabulary); input_list: list file
of .perfil paths (one utterance each) — for MULTI-STREAM vocabularies pass
a comma-separated list of per-stream list files (the reference reads one
feature file per stream, R2:331-339); output_file receives one
line per utterance:  <perfil>  <score>  <word sequence>, plus N-best
blocks when --n-best > 1.  --ref gives a transcript file (one line per utterance,
space-separated words) and adds a WER summary.

--lm: language model log-probs — a text file of either W lines (unigram:
"word logprob") or W*W lines (bigram: "prev next logprob"), or a .npy
array of shape (W,) / (W, W).  --lm-scale and --word-penalty are the
standard acoustic/LM balance knobs (decode/continuous.py).  --batch packs
every utterance into one padded batch and decodes them all as one program
(decode_continuous_batch); default is the per-utterance engine.  Both
support any n_best and give the same hypotheses.

This is the capability the reference lacks entirely (isolated words only,
SURVEY §0); BASELINE.json config 3.
"""

from __future__ import annotations

import argparse
import sys


def _read_lm(path: str, words: list[str]):
    """(W,) unigram or (W, W) bigram log-probs from .npy or text."""
    import numpy as np

    if path.endswith(".npy"):
        lm = np.load(path)
        if lm.shape not in ((len(words),), (len(words), len(words))):
            raise SystemExit(
                f"--lm: shape {lm.shape} does not match vocabulary "
                f"W={len(words)}"
            )
        return lm
    idx = {w: i for i, w in enumerate(words)}
    rows = [l.split() for l in open(path).read().splitlines() if l.strip()]
    if all(len(r) == 2 for r in rows):
        lm = np.full(len(words), -np.inf)
        for w, lp in rows:
            lm[idx[w]] = float(lp)
        return lm
    if all(len(r) == 3 for r in rows):
        lm = np.full((len(words), len(words)), -np.inf)
        for u, v, lp in rows:
            lm[idx[u], idx[v]] = float(lp)
        return lm
    raise SystemExit("--lm: lines must be 'word logprob' or 'prev next logprob'")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model_list")
    ap.add_argument("input_list")
    ap.add_argument("output_file")
    ap.add_argument("--n-best", type=int, default=1)
    ap.add_argument("--exit-logprob", type=float, default=None)
    ap.add_argument("--ref", default=None)
    ap.add_argument("--lm", default=None, help="unigram/bigram log-prob file")
    ap.add_argument("--lm-scale", type=float, default=None)
    ap.add_argument("--word-penalty", type=float, default=None)
    ap.add_argument(
        "--batch", action="store_true",
        help="decode all utterances as one padded batch",
    )
    ns = ap.parse_args(argv)

    from ..ops.backend import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from ..decode.continuous import decode_continuous, decode_continuous_batch
    from ..eval.metrics import WerCounts, edit_alignment
    from ..io import read_list, read_perfil, read_vocabulary
    from ..models import stack_models

    vocab = stack_models(read_vocabulary(ns.model_list)).astype(jnp.float32)
    words = list(vocab.word)
    kwargs = {}
    if ns.exit_logprob is not None:
        kwargs["exit_logprob"] = ns.exit_logprob
    if ns.lm is not None:
        kwargs["lm_logprobs"] = _read_lm(ns.lm, words)
    if ns.lm_scale is not None:
        kwargs["lm_scale"] = ns.lm_scale
    if ns.word_penalty is not None:
        kwargs["word_insertion_penalty"] = ns.word_penalty

    refs = None
    if ns.ref:
        refs = [l.split() for l in open(ns.ref).read().splitlines() if l.strip()]

    stream_lists = ns.input_list.split(",")
    n_streams = len(vocab.streams)
    if len(stream_lists) != n_streams:
        raise SystemExit(
            f"vocabulary has {n_streams} stream(s); pass {n_streams} "
            f"comma-separated input list(s), got {len(stream_lists)}"
        )
    per_stream_paths = [list(read_list(sl)) for sl in stream_lists]
    paths = per_stream_paths[0]
    if any(len(pp) != len(paths) for pp in per_stream_paths):
        raise SystemExit("per-stream input lists must have equal lengths")
    multi = n_streams > 1
    if ns.batch:
        from ..io.dataset import pack_utterances

        batches = tuple(
            pack_utterances(
                [np.asarray(read_perfil(p), np.float32) for p in pp],
                pad_multiple=128, dtype=jnp.float32,
            )
            for pp in per_stream_paths
        )
        results = decode_continuous_batch(
            vocab, batches if multi else batches[0],
            n_best=ns.n_best, **kwargs,
        )
        all_hyps = [r if isinstance(r, list) else [r] for r in results]
    else:
        all_hyps = None

    total = WerCounts()
    with open(ns.output_file, "w") as out:
        for i, path in enumerate(paths):
            if all_hyps is not None:
                hyps = all_hyps[i]
            else:
                frames = tuple(
                    jnp.asarray(read_perfil(pp[i]), jnp.float32)
                    for pp in per_stream_paths
                )
                hyps = decode_continuous(
                    vocab, frames if multi else frames[0],
                    n_best=ns.n_best, **kwargs,
                )
            best_score, best_words, spans = hyps[0]
            hyp_words = [words[w] for w in best_words]
            out.write(f"{path}\t{best_score:.4f}\t{' '.join(hyp_words)}\n")
            for rank_i, (sc, ws, _) in enumerate(hyps[1:], start=2):
                out.write(
                    f"#  {rank_i}-best\t{sc:.4f}\t"
                    f"{' '.join(words[w] for w in ws)}\n"
                )
            if refs is not None and i < len(refs):
                total = total + edit_alignment(refs[i], hyp_words)
        if refs is not None:
            out.write(
                f"\nWER: {total.wer * 100.0:.2f}%  "
                f"(S={total.substitutions} I={total.insertions} "
                f"D={total.deletions} N={total.num_ref_words})\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
