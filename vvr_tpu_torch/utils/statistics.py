"""Statistics & benchmarking — rolling pass timings + capture benchmark.

Parity with src/statistics.rs: an 8-frame rolling average of the main-pass
GPU time (:26-29) and a timed benchmark capture reporting sample count,
average ms and stddev (:43-64; reference duration 2 s, trigger L key).
Here the 'timestamp query' is a host clock around a frame that ends in
torch.cuda.synchronize (render/renderer.py). Adds Mrays/s, the headline
metric. A copy of vvr_tpu/utils/statistics.py."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Benchmark:
    starting_frame: int
    starting_time: float
    timings: list


class Statistics:
    ROLLING = 8  # statistics.rs:12 (delta_ms_buffer length)

    def __init__(self, benchmark_duration_s: float = 2.0):
        self.delta_ms_buffer = [0.0] * self.ROLLING
        self.benchmark: Benchmark | None = None
        self.benchmark_duration_s = benchmark_duration_s
        self.last_result: dict | None = None

    def push_timing(self, delta_ms: float):
        self.delta_ms_buffer = [delta_ms] + self.delta_ms_buffer[:-1]

    def average_ms(self) -> float:
        return sum(self.delta_ms_buffer) / len(self.delta_ms_buffer)

    def start_benchmarking(self, frame: int):
        self.benchmark = Benchmark(frame, time.monotonic(), [])

    def end_of_frame(self, frame: int) -> dict | None:
        """Returns the benchmark result dict when a capture completes."""
        b = self.benchmark
        if b is None or frame <= b.starting_frame + self.ROLLING:
            return None
        b.timings.append(self.average_ms())
        if time.monotonic() - b.starting_time > self.benchmark_duration_s:
            n = len(b.timings)
            avg = sum(b.timings) / n
            var = sum((x - avg) ** 2 for x in b.timings)
            stddev = var ** 0.5 / n  # statistics.rs:59 (their normalization)
            self.last_result = dict(samples=n, avg_ms=avg, stddev=stddev)
            self.benchmark = None
            return self.last_result
        return None


def mrays_per_sec(rays_per_frame: int, frame_ms: float) -> float:
    if frame_ms <= 0:
        return float("inf")
    return rays_per_frame / (frame_ms * 1e-3) / 1e6
