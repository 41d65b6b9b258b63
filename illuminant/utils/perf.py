"""Frame performance statistics.

Port of AppCommon/PerformanceStats.cs:12-58 in the reference: rolling
N-sample averages of named frame phases -> ms/frame + FPS. A `sync`
array passed to `end`/`end_frame` is waited on with
`jax.block_until_ready` before the clock is read; pass one only for the
phases you want timed, since waiting serializes the pipeline you measure.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict

import jax


class PerformanceStats:
    """Rolling averages over the last `samples` frames per phase."""

    def __init__(self, samples: int = 200):
        self.samples = samples
        self._phases: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.samples)
        )
        self._open: Dict[str, float] = {}
        self._frame_start = None
        self._frame_times: deque = deque(maxlen=samples)

    def begin_frame(self):
        self._frame_start = time.perf_counter()

    def end_frame(self, sync=None):
        if sync is not None:
            jax.block_until_ready(sync)
        if self._frame_start is not None:
            self._frame_times.append(
                time.perf_counter() - self._frame_start
            )
            self._frame_start = None

    def begin(self, phase: str):
        self._open[phase] = time.perf_counter()

    def end(self, phase: str, sync=None):
        if sync is not None:
            jax.block_until_ready(sync)
        start = self._open.pop(phase, None)
        if start is not None:
            self._phases[phase].append(time.perf_counter() - start)

    def mean_ms(self, phase: str) -> float:
        values = self._phases.get(phase)
        if not values:
            return 0.0
        return sum(values) / len(values) * 1e3

    @property
    def frame_ms(self) -> float:
        if not self._frame_times:
            return 0.0
        return sum(self._frame_times) / len(self._frame_times) * 1e3

    @property
    def fps(self) -> float:
        ms = self.frame_ms
        return 1000.0 / ms if ms > 0 else 0.0

    def report(self) -> str:
        parts = [f"frame {self.frame_ms:.2f} ms ({self.fps:.1f} fps)"]
        for phase in sorted(self._phases):
            parts.append(f"{phase} {self.mean_ms(phase):.2f} ms")
        return " | ".join(parts)
