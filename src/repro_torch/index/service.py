"""Archive query-serving front end: request queue → batched scans → ranked hits.

Callers submit :class:`QueryRequest`\\ s, the service drains the queue in
fixed-size request batches, runs each through the shared
:class:`QueryEngine` (whose candidate scans are themselves batched
kernel launches), and returns ranked hit lists with record excerpts.
One engine instance is shared across the queue so per-shard readers
stay open between requests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .cdx import CdxIndex
from .query import HeaderFilter, PatternHit, QueryEngine

__all__ = ["IndexQueryService", "QueryRequest", "QueryResponse"]

_BATCH_SIZE = 8  # requests drained per batch


@dataclass
class QueryRequest:
    """One search: a byte pattern plus optional header predicates.

    ``regex=True`` interprets ``pattern`` as a bytes regex source
    (served through :meth:`QueryEngine.search_regex`).
    """

    pattern: bytes
    filters: HeaderFilter | None = None
    top_k: int = 10
    prefilter: bool = True
    regex: bool = False


@dataclass
class QueryResponse:
    request: QueryRequest
    hits: list[PatternHit] = field(default_factory=list)
    total_matches: int = 0       # matched records before top_k truncation
    latency_s: float = 0.0


class IndexQueryService:
    """Drain query requests in batches against one shared engine, on
    ``device`` (default the GPU; ``"cpu"`` only when asked)."""

    def __init__(self, index: CdxIndex, *, device="cuda") -> None:
        self.engine = QueryEngine(index, device=device)
        self._queue: list[QueryRequest] = []
        self.stats = {"requests": 0, "batches": 0, "hits_returned": 0,
                      "serve_s": 0.0}

    # -- request intake --------------------------------------------------
    def submit(self, request: QueryRequest) -> None:
        self._queue.append(request)

    # -- serving ---------------------------------------------------------
    def run_batch(self, requests: list[QueryRequest]) -> list[QueryResponse]:
        """Serve one batch of requests; hits ranked by match count."""
        responses = []
        for req in requests:
            t0 = time.perf_counter()
            if req.regex:
                hits = self.engine.search_regex(req.pattern, req.filters,
                                                prefilter=req.prefilter)
            else:
                hits = self.engine.search(req.pattern, req.filters,
                                          prefilter=req.prefilter)
            # rank: most matches first, index order breaks ties (stable)
            ranked = sorted(hits, key=lambda h: -h.n_matches)
            responses.append(QueryResponse(
                request=req, hits=ranked[:req.top_k],
                total_matches=len(hits),
                latency_s=time.perf_counter() - t0))
        self.stats["requests"] += len(requests)
        self.stats["batches"] += 1
        self.stats["hits_returned"] += sum(len(r.hits) for r in responses)
        self.stats["serve_s"] += sum(r.latency_s for r in responses)
        return responses

    def drain(self) -> list[QueryResponse]:
        """Serve everything queued, in submission order, batch by batch."""
        responses: list[QueryResponse] = []
        while self._queue:
            batch = self._queue[:_BATCH_SIZE]
            del self._queue[:_BATCH_SIZE]
            responses.extend(self.run_batch(batch))
        return responses

    def serve(self, requests: list[QueryRequest]) -> list[QueryResponse]:
        for req in requests:
            self.submit(req)
        return self.drain()

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self.engine.close()

    def __enter__(self) -> "IndexQueryService":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
