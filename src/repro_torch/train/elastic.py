"""Fault tolerance for training: liveness and straggler detection (a copy
of the reference's ``repro.train.elastic`` host pieces).

* :class:`Heartbeat` tracks per-host liveness; a host is dead after
  ``timeout`` s of silence.
* :class:`StragglerMonitor` EMA-tracks step times; a step slower than
  ``threshold ×`` the EMA is a straggler, and ``train_lm`` checkpoints
  early after sustained ones.

The mesh pieces (``shrunken_mesh``, ``rescale_batch_for_mesh``) wait for
the multi-device slice (ROADMAP item 6).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["Heartbeat", "HostFailure", "StragglerMonitor"]


class HostFailure(RuntimeError):
    def __init__(self, host_ids: list[int]):
        super().__init__(f"hosts failed: {host_ids}")
        self.host_ids = host_ids


class Heartbeat:
    """Liveness registry; a host is dead after ``timeout`` s of silence."""

    def __init__(self, n_hosts: int, timeout: float = 60.0,
                 clock=time.monotonic) -> None:
        self.timeout = timeout
        self._clock = clock
        now = clock()
        self._last_seen = {h: now for h in range(n_hosts)}

    def ping(self, host: int) -> None:
        self._last_seen[host] = self._clock()

    def dead_hosts(self) -> list[int]:
        now = self._clock()
        return [h for h, t in self._last_seen.items()
                if now - t > self.timeout]

    def check(self) -> None:
        dead = self.dead_hosts()
        if dead:
            raise HostFailure(dead)


@dataclass
class StragglerMonitor:
    """EMA step-time tracker with slowdown flagging."""

    threshold: float = 2.0
    alpha: float = 0.1
    ema: float | None = None
    slow_steps: int = field(default=0)
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True when the step was a straggler."""
        if self.ema is None:
            self.ema = seconds
            return False
        slow = seconds > self.threshold * self.ema
        if slow:
            self.slow_steps += 1
            self.events.append((step, seconds, self.ema))
            # slow steps do not poison the EMA (one bad host would
            # otherwise ratchet the baseline up)
        else:
            self.ema = self.alpha * seconds + (1 - self.alpha) * self.ema
        return slow

    def should_checkpoint_early(self, consecutive: int = 3) -> bool:
        if len(self.events) < consecutive:
            return False
        recent = self.events[-consecutive:]
        return recent[-1][0] - recent[0][0] == consecutive - 1
