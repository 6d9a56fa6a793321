"""Deterministic process-fault injection.

:func:`arm_worker_kill` arms the process pool's in-tree hook
(``REPRO_TORCH_FAULT_WORKER_KILL``, read by
:func:`repro_torch.core.parallel._maybe_worker_kill`) with a fresh
one-shot latch file, so exactly one pool worker dies per armed context
no matter how many workers inherit the environment. The pool captures
the spec when it starts a worker, so arm before building the pool.
"""
from __future__ import annotations

import contextlib
import os
import uuid

__all__ = ["arm_worker_kill"]


@contextlib.contextmanager
def _armed(var: str, latch_dir: str, spec_tail: str):
    latch = os.path.join(str(latch_dir), f"fault-latch-{uuid.uuid4().hex}")
    prev = os.environ.get(var)
    os.environ[var] = f"{latch}:{spec_tail}"
    # armed faults are themselves counted, so a merged snapshot from a
    # fault-injection run says which faults were live
    from repro_torch import obs

    obs.registry().counter_add(f"faults.armed.{var}")
    try:
        yield latch
    finally:
        if prev is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = prev
        with contextlib.suppress(OSError):
            os.unlink(latch)


def arm_worker_kill(latch_dir: str, nth: int = 1):
    """Arm ``REPRO_TORCH_FAULT_WORKER_KILL``: the first pool worker
    (across the whole process tree sharing this environment) to reach
    its ``nth`` produced result wins the latch and hard-exits
    (``os._exit``) before sending it. Yields the latch path; the latch
    file existing afterwards means the fault actually fired.
    """
    from repro_torch.core.parallel import FAULT_WORKER_KILL_ENV

    return _armed(FAULT_WORKER_KILL_ENV, latch_dir, str(int(nth)))
