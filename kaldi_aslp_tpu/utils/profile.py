"""Profiling utilities.

JAX-native equivalents of the reference's profiling hooks (reference:
CuDevice::AccuProfile/PrintProfile src/aslp-cudamatrix/cu-device.h:87-88
— per-op cumulative timers printed at exit; per-component Propagate
timing nnet-nnet.cc:97-100 / GetComponentTime; frames/sec throughput
logs aslp-nnet-train-simple.cc:245-250).

Since everything under jit is fused, per-op host timers are meaningless
on a device; what carries over is (a) named region accumulation around
dispatch+sync boundaries, (b) the audio-seconds/s counter, (c) a hook
into jax.profiler for real traces."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import jax


class AccuProfiler:
    """Cumulative wall-time per named region (AccuProfile equivalent).

    Use `with prof.region("ctc-loss"): ...`; wrap device work with
    block_until_ready for honest numbers."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> str:
        """(reference: PrintProfile output shape)."""
        lines = ["-----\n[profile]"]
        total = sum(self._acc.values())
        for name, t in sorted(self._acc.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}\t{t:.3f}s\t{self._count[name]} calls"
                f"\t{100 * t / max(total, 1e-9):.1f}%"
            )
        lines.append(f"total\t{total:.3f}s\n-----")
        return "\n".join(lines)


class ThroughputMeter:
    """frames/sec + audio-seconds/s counter (the reference's fps log and
    bench.py's primary metric)."""

    def __init__(self, frame_shift_s: float = 0.01):
        self.frame_shift_s = frame_shift_s
        self.frames = 0
        self._start = time.monotonic()

    def add_frames(self, n: int) -> None:
        self.frames += int(n)

    @property
    def frames_per_sec(self) -> float:
        return self.frames / max(time.monotonic() - self._start, 1e-9)

    @property
    def audio_seconds_per_sec(self) -> float:
        return self.frames_per_sec * self.frame_shift_s

    def report(self) -> str:
        return (f"throughput: {self.frames_per_sec:.0f} frames/s "
                f"({self.audio_seconds_per_sec:.1f} audio-s/s)")


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (TensorBoard-viewable)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
