"""Serving layer: the sharded archive query gateway and the LM engine.

* :mod:`.engine` — batched LM serving (KV-cache prefill + decode loop,
  attention through the flash-attention kernel);
* :mod:`.archive` — the async archive query gateway: admission queue
  with backpressure, request coalescing, cross-request kernel batching
  and a byte-budgeted record cache over :mod:`repro_torch.index`;
* :mod:`.shard` — one supervised scheduler shard of the gateway;
* :mod:`.cache` / :mod:`.metrics` — the gateway's payload cache and its
  measurement surface (a facade over :mod:`repro_torch.obs`).

>>> from repro_torch.serve import ArchiveGateway
>>> with ArchiveGateway(index, shards=4) as gw:         # on the GPU
...     hits = gw.query(QueryRequest(b"nginx")).hits
"""
from .archive import (ArchiveGateway, GatewayClosed, GatewayOverloaded,
                      GatewayShardDown, GatewayTimeout)
from .cache import RecordCache, ShardedRecordCache
from .engine import Request, ServeEngine
from .metrics import GatewayMetrics, percentile
from .shard import ShardScheduler

__all__ = [
    "ArchiveGateway",
    "GatewayClosed",
    "GatewayOverloaded",
    "GatewayShardDown",
    "GatewayTimeout",
    "GatewayMetrics",
    "RecordCache",
    "Request",
    "ServeEngine",
    "ShardedRecordCache",
    "ShardScheduler",
    "percentile",
]
