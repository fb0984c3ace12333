"""Profiling / tracing hooks.

The reference profiles with gprof (-pg in every Makefile) and coarse
times()-based counters (SURVEY §5).  Replacements:

* `trace(dir)` — jax.profiler trace context (XLA device timeline, viewable in
  TensorBoard / xprof);
* `Throughput` — audio-seconds/s and frames/s counters with device sync;
* `timed` — block timer with block_until_ready semantics for honest device
  timing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import jax


@contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def timed(result: dict, key: str = "seconds", sync: object = None):
    """Wall-time the block; if `sync` is a jax value, block on it first so
    device work is included."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        jax.block_until_ready(sync)
    result[key] = time.perf_counter() - t0


class Throughput:
    """Audio-seconds/s, frames/s bookkeeping across steps."""

    def __init__(self, frame_shift_s: float = 0.01):
        self.frame_shift_s = frame_shift_s
        self.frames = 0
        self.seconds = 0.0

    def add(self, num_frames: int, seconds: float):
        self.frames += int(num_frames)
        self.seconds += seconds

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    @property
    def audio_seconds_per_sec(self) -> float:
        return self.frames_per_sec * self.frame_shift_s

    @property
    def rtf(self) -> float:
        """Real-time factor (processing time / audio time); lower is faster."""
        audio = self.frames * self.frame_shift_s
        return self.seconds / audio if audio else 0.0
