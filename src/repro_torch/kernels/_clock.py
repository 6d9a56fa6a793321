"""Stage timing shared by the grouped kernel wrappers."""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Clock", "sync"]


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Clock:
    """Device time of a call's stages: each ``span`` is bracketed by CUDA
    events on the card (read after the call's one synchronize, so timing
    adds none, and host time between the spans is not counted), by the
    host clock on the CPU, where every stage runs synchronously."""

    def __init__(self, dev: torch.device) -> None:
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def _mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    @contextlib.contextmanager
    def span(self):
        self._mark()
        yield
        self._mark()

    def spans_us(self) -> list[int]:
        pairs = zip(self.marks[::2], self.marks[1::2])
        if self.cuda:
            return [int(a.elapsed_time(b) * 1e3) for a, b in pairs]
        return [int((b - a) * 1e6) for a, b in pairs]
