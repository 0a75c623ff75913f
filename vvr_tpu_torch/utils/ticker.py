"""Fixed-tick accumulator — 50 ticks/s, at most one tick per frame.

Counterpart of vvr_tpu/utils/ticker.py (src/ticker.rs:9-22; instantiated
but unused in the reference's frame loop, src/renderer.rs:346; app.py
updates it every frame)."""

from __future__ import annotations


class Ticker:
    TICK_RATE = 50.0

    def __init__(self):
        self.accumulator = 0.0
        self.tick_count = 0

    def update(self, delta: float) -> bool:
        """Accumulate frame time; returns True when a tick fires (max one)."""
        self.accumulator += delta
        if self.accumulator >= 1.0 / self.TICK_RATE:
            self.accumulator -= 1.0 / self.TICK_RATE
            self.accumulator = min(self.accumulator, 1.0 / self.TICK_RATE)
            self.tick_count += 1
            return True
        return False
