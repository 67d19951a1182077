"""Controllable clock so time-dependent behaviors (sla waiting, tdm windows,
TTL garbage collection) are deterministic under test."""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += seconds

    def advance(self, seconds: float) -> None:
        self._now += seconds


GLOBAL_CLOCK = Clock()
