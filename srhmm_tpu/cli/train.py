"""Training CLI mirroring the reference argv contract.

Usage (hmm-full-fs/hmm_continuous_full_fs.c:166-176):

    python -m srhmm_tpu.cli.train word states_number param_number
        mix_number1 ... mix_numberN input_file1 ... input_fileN
        output_file [initial_model]

input_fileK is a list file naming one .perfil per training exemplar for
stream K.  Writes the binary model to output_file and the text summary to
the reference's derived name (first-dot truncation + ".txt").

Optional leading flags:
    --cov full|diag   covariance type (full = hmm_continuous_full_fs,
                      diag = hmm_continuous_fs); default full
    --threshold X     convergence threshold (default 1e-3, T1:36)
    --size-t-width N  .hmm size_t width (default 4, matching the fixtures)
    --numerics parity|fast
                      parity = float64 reference-exact EM (default; CPU);
                      fast = log-space batched EM on the default device,
                      f32, native batched data loading
    --checkpoint-dir D
                      (fast path) checkpoint every EM iteration to D and
                      resume from the newest complete checkpoint
    --scan-iters N    (fast path) fixed-budget production mode: run exactly
                      N EM iterations as ONE jitted lax.scan
                      (train/em.em_train_scan — no per-iteration program
                      launches or host syncs), skipping the reference's
                      convergence rule
    --stream-shards N (fast path) stream the dataset through the device in
                      N shards with the async double-buffered input
                      pipeline (io/pipeline.py): shard k+1's host->device
                      copy overlaps shard k's E-step — for datasets larger
                      than device memory (SURVEY §2.4 threads/async row)
    --cmvn global     (fast path) train in globally mean/variance-normalized
                      feature space and de-normalize the exported model —
                      the f32 precision lever for raw-scale features (the
                      .perfil profiles reach |x| ~ 3e3, where f32 moment
                      statistics lose ~mean^2/variance of their precision);
                      EM is exactly equivariant under the affine map, so
                      the exported raw-space model and the reported mean
                      probability (Jacobian-corrected) are unchanged up to
                      float rounding

The reference's warm-start bug (argv[argc] off-by-one, T1:204, which made the
documented initial_model argument unusable) is fixed, not replicated.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(add_help=True)
    ap.add_argument("--cov", choices=["full", "diag"], default="full")
    ap.add_argument("--threshold", type=float, default=1.0e-3)
    ap.add_argument("--size-t-width", type=int, default=4)
    ap.add_argument("--numerics", choices=["parity", "fast"], default="parity")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--scan-iters", type=int, default=None)
    ap.add_argument("--cmvn", choices=["off", "global"], default="off")
    ap.add_argument("--stream-shards", type=int, default=None)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    rest = ns.rest
    if len(rest) < 5:
        print(
            "Usage: train word states_number param_number mix_number1 ... "
            "mix_numberN input_file1 ... input_fileN output_file [initial_model]",
            file=sys.stderr,
        )
        return 1

    import jax

    if ns.numerics == "parity":
        # the parity path is the reference-exact float64 oracle: it runs on
        # the CPU's IEEE double arithmetic by design
        jax.config.update("jax_platforms", "cpu")
    else:
        from ..ops.backend import enable_compile_cache

        enable_compile_cache()

    from ..eval.report import (
        c_strftime_cpu,
        c_strftime_datetime,
        c_text_file_name,
        trainer_text_summary,
    )
    from ..init.lbg import create_initial_model
    from ..io import read_hmm, read_list, read_perfil, write_hmm
    from ..train.em_parity import train_word_parity

    start_wall = time.time()
    starting_time = c_strftime_datetime(start_wall)

    word = rest[0]
    states_number = int(rest[1])
    param_number = int(rest[2])
    mixture_numbers = [int(x) for x in rest[3 : 3 + param_number]]
    data_files = rest[3 + param_number : 3 + 2 * param_number]
    output_file = rest[3 + 2 * param_number]
    initial_model = (
        rest[3 + 2 * param_number + 1]
        if len(rest) > 3 + 2 * param_number + 1
        else None
    )

    if ns.numerics == "fast":
        # native batched loading (io/dataset.load_batch -> native/loader.cpp
        # worker pool when buildable): one threaded pass straight into the
        # padded (B, T, D) arrays the fast path trains on.  The LBG init
        # consumes per-utterance views of the same arrays — nothing is read
        # from disk twice (the reference re-reads every .perfil twice per EM
        # iteration, T1:259/287).
        import jax.numpy as jnp
        import numpy as np

        from ..io.dataset import load_batch

        batches_f64 = tuple(
            load_batch(df, dtype=jnp.float64) for df in data_files
        )
        utterances_per_stream = [
            [
                np.asarray(b.features[i, : int(b.lengths[i])], np.float64)
                for i in range(b.batch_size)
            ]
            for b in batches_f64
        ]
        cmvn_stats = None
        cmvn_offset = 0.0
        cmvn_abs_floors = None
        cmvn_zd = None
        if ns.cmvn == "global":
            # train in globally-normalized feature space (the f32 precision
            # lever, features.frontend.global_cmvn_stats): EM is exactly
            # equivariant under the affine map, and the trained model is
            # de-normalized back to raw space before export
            from ..features.frontend import global_cmvn_stats

            cmvn_stats = [
                global_cmvn_stats(b.features, b.lengths) for b in batches_f64
            ]
            # NOTE: the LBG init still runs on RAW utterances (its isotropic
            # Euclidean metric is not affine-equivariant, so normalizing the
            # init data would change the starting model); the raw-space
            # initial model is mapped into normalized space below
            # constant Jacobian correction: log p_raw = log p_norm -
            # frames * sum(log std) per stream — applied INSIDE the
            # convergence rule (the reference's relative-change test is not
            # shift-invariant) and to every reported probability
            import numpy as np

            cmvn_offset = -sum(
                int(np.asarray(b.lengths).sum()) * float(np.log(s).sum())
                for b, (_, s) in zip(batches_f64, cmvn_stats)
            )
            batches_f64 = tuple(
                b.replace(features=(b.features - m) / s)
                for b, (m, s) in zip(batches_f64, cmvn_stats)
            )
            # the reference's ABSOLUTE 1e-5 variance floor must scale with
            # the transform to act at raw-space magnitudes (train/em
            # .update_stream abs_floor)
            from ..models.gmm_hmm import FINITE_PROBAB

            cmvn_abs_floors = tuple(
                jnp.asarray(FINITE_PROBAB / (s * s), jnp.float32)
                for (_, s) in cmvn_stats
            )
            # ... as must the treat_zero_det trigger (log 1e-20, also an
            # absolute raw-space quantity)
            cmvn_zd = tuple(
                float(np.log(1e-20) - 2.0 * np.log(s).sum())
                for (_, s) in cmvn_stats
            )
        batches = tuple(
            b.replace(features=b.features.astype(jnp.float32))
            for b in batches_f64
        )
    else:
        utterances_per_stream = [
            [read_perfil(p) for p in read_list(df)] for df in data_files
        ]

    if initial_model:
        model = read_hmm(initial_model)
        model = model.replace(word=word)
    else:
        model = create_initial_model(
            utterances_per_stream,
            states_number,
            mixture_numbers,
            word=word,
            cov_type=ns.cov,
        )

    print("\nCreating HMM using Forward-Backward algorithm (Baum-Welch)")
    if ns.numerics == "fast":
        import jax.numpy as jnp

        from ..train.em import train_fast
        from ..utils import EventLog

        log = EventLog()
        batch = batches[0] if len(batches) == 1 else batches
        if ns.cmvn == "global":
            # the initial model (LBG or warm start) is in raw feature
            # space; map it into the normalized space the batch lives in
            # (the inverse affine: denormalize with mean' = -m/s,
            # std' = 1/s)
            from ..models.gmm_hmm import denormalize_model

            model = denormalize_model(
                model, [(-m / s, 1.0 / s) for (m, s) in cmvn_stats]
            )
        fast_model = model.astype(jnp.float32)
        with log.span("train_fast", word=word):
            if ns.scan_iters:
                # fixed-budget production mode: N iterations as ONE jitted
                # scan, zero host round trips inside the loop
                import numpy as np

                from ..train.em import em_train_scan
                from ..train.em_parity import TrainResult

                final, lps, nvs = em_train_scan(
                    fast_model, batch, ns.scan_iters,
                    abs_floors=cmvn_abs_floors, zero_det_thresholds=cmvn_zd,
                )
                lps_h = np.asarray(lps) + cmvn_offset
                nv = int(np.asarray(nvs)[-1])
                res = TrainResult(
                    model=final,
                    iterations=ns.scan_iters,
                    mean_log_prob=float(lps_h[-1]) / max(nv, 1),
                    exemplar_count=nv,
                    log_prob_history=[float(x) for x in lps_h],
                )
            elif ns.checkpoint_dir:
                from ..train.checkpoint import train_fast_resumable

                res = train_fast_resumable(
                    fast_model, batch, ns.checkpoint_dir,
                    threshold=ns.threshold, log_prob_offset=cmvn_offset,
                )
            elif ns.stream_shards:
                import numpy as np

                from ..train.streaming import shard_batch, train_streaming

                host = batch.replace(
                    features=np.asarray(batch.features),
                    lengths=np.asarray(batch.lengths),
                )
                res = train_streaming(
                    fast_model,
                    shard_batch(host, ns.stream_shards),
                    threshold=ns.threshold,
                    log_prob_offset=cmvn_offset,
                    abs_floors=cmvn_abs_floors,
                    zero_det_thresholds=cmvn_zd,
                )
            else:
                res = train_fast(
                    fast_model, batch, threshold=ns.threshold,
                    log_prob_offset=cmvn_offset, abs_floors=cmvn_abs_floors,
                    zero_det_thresholds=cmvn_zd,
                )
        log.emit(
            "converged", iterations=res.iterations,
            mean_log_prob=res.mean_log_prob,
        )
        if cmvn_stats is not None:
            from ..models.gmm_hmm import denormalize_model

            # back to raw feature space (exact inverse affine); reported
            # probabilities already carry the Jacobian offset
            res.model = denormalize_model(res.model, cmvn_stats)

        # export in float64 (file contract); recompute linear det from
        # log_det on the host
        import numpy as np

        def to_f64(s):
            det = np.exp(np.asarray(s.log_abs_det(), np.float64))
            return s.replace(
                weights=jnp.asarray(np.asarray(s.weights, np.float64)),
                means=jnp.asarray(np.asarray(s.means, np.float64)),
                inv_cov=jnp.asarray(np.asarray(s.inv_cov, np.float64)),
                det=jnp.asarray(det),
                log_det=None,
            )

        res.model = res.model.replace(
            trans=jnp.asarray(np.asarray(res.model.trans, np.float64)),
            streams=tuple(to_f64(s) for s in res.model.streams),
        )
    else:
        res = train_word_parity(
            utterances_per_stream, model, threshold=ns.threshold
        )
    print(f"\nFinal model after {res.iterations} iterations, "
          f"mean probability {res.mean_log_prob:f}")

    write_hmm(output_file, res.model, size_t_width=ns.size_t_width)

    text_file = c_text_file_name(output_file)
    cpu_seconds = time.process_time()
    with open(text_file, "w") as f:
        f.write(
            trainer_text_summary(
                model_file=output_file,
                word=word,
                states_number=states_number,
                param_number=param_number,
                mixture_numbers=mixture_numbers,
                data_files=data_files,
                threshold=ns.threshold,
                exemplar_number=res.exemplar_count,
                mean_probability=res.mean_log_prob,
                iterations=res.iterations,
                starting_time=starting_time,
                ending_time=c_strftime_datetime(),
                cpu_time=c_strftime_cpu(cpu_seconds),
                cov_type=ns.cov,
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
