"""Test support: deterministic process-fault injection for the pool's
supervision tests (import-light: no CUDA work, no heavy dependencies)."""
from .faults import arm_worker_kill

__all__ = ["arm_worker_kill"]
