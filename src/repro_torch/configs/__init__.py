"""Architecture registry: ``--arch <id>`` configs + their shape sets.

Each ``<id>.py`` defines ``SPEC: ArchSpec`` with the exact published
config, its input-shape set, and a reduced config for CPU smoke tests
(copies of the reference's entries). The registry lists only the
architectures the port carries: the paper's ``fastwarc_lm`` and
``internlm2_1_8b`` (dense GQA LMs); the MoE, GNN and recsys
architectures follow with their model families.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any

__all__ = ["ARCH_IDS", "ArchSpec", "ShapeSpec", "get_spec", "lm_shapes"]

ARCH_IDS = [
    "internlm2_1_8b",
    # the paper's own end-to-end config (WARC-pipeline-fed LM)
    "fastwarc_lm",
]

#: canonical ``--arch`` spelling (dashes) -> module name
_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # train | prefill | decode | serve
    params: dict = field(default_factory=dict)
    skip_reason: str | None = None   # e.g. long_500k on full attention


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str            # lm
    config: Any
    reduced: Any           # smoke-test-scale config of the same family
    shapes: tuple          # tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}")


def get_spec(arch_id: str) -> ArchSpec:
    arch_id = _ALIAS.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    module = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return module.SPEC


# -- shared LM shape set (assigned to every LM-family arch) -----------------

def lm_shapes(*, sub_quadratic: bool = False) -> tuple:
    skip = (None if sub_quadratic else
            "full quadratic attention at 524k tokens is infeasible by "
            "construction; arch has no sub-quadratic variant (DESIGN.md §5)")
    return (
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill",
                  {"seq_len": 32768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode",
                  {"seq_len": 32768, "global_batch": 128}),
        ShapeSpec("long_500k", "decode",
                  {"seq_len": 524288, "global_batch": 1},
                  skip_reason=skip),
    )
