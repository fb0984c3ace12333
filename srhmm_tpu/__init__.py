"""srhmm_tpu — continuous-density GMM-HMM speech recognition framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`edielsonpf/speech-recognition-hmm-continuous` (reference mounted at
/root/reference): Baum-Welch EM training and forward/Viterbi recognition of
continuous-density (GMM-emission) left-to-right HMMs, plus the subsystems the
reference lacks (feature frontend, batching, data/model parallelism over
device meshes, structured metrics, checkpointing, benchmarks).  Its
accelerator is an NVIDIA GPU; ops/backend.py picks each job's
implementation per platform.

Package map (reference capability -> subsystem):
  io/        .perfil / .hmm codecs (reference-compatible), padded batching
             (ref: reading_coef* / reading_model / writing_model,
              train/source/hmm-full-fs/hmm_continuous_full_fs.c:515-710,2286-2399)
  models/    GMM-HMM parameter pytrees, diag & full covariance, vocab stacking
  ops/       emission log-likelihood, forward/backward scans, Viterbi
             (ref: calc_gaus/calc_symbol_probab/calc_alpha/calc_beta,
              hmm-full-fs:1414-1887), the Triton lattice kernels, and
             backend.py (implementation choice, precision, compile cache)
  init/      uniform segmentation + LBG split k-means initialization
             (ref: init_mix_mean/splitting/classifying, hmm-full-fs:970-1311)
  train/     Baum-Welch EM driver, sufficient statistics, M-step
             (ref: EM loop hmm-full-fs:223-346)
  decode/    isolated-word scoring (total-prob & final-state modes), continuous
             token-passing Viterbi (ref: recognition_continuous_*fs.c)
  parallel/  jax.sharding mesh utilities, data/model-parallel EM collectives
  eval/      accuracy metrics + report writers matching the reference formats
  features/  MFCC/filterbank frontend (GEMM-native STFT+mel+DCT) [new capability]
  pipeline   the whole framework as ONE system: audio -> MFCC -> LBG ->
             monophone EM -> decision-tree tying -> tied EM -> materialized
             lexicon -> bigram n-best batched decode -> WER
  checks     the production paths compared with their plain references
             (run by chip_smoke.py on the GPU and by the tests)
  cli/       train / recognize / decode / train_embedded / pipeline entry
             points (reference argv contracts where applicable)

float64 is enabled globally: the reference is double-precision C and the
bit-comparable parity paths need f64. The fast paths request f32/bf16
explicitly, so enabling x64 does not slow them down.
"""

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
