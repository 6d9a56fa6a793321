"""``repro_torch.index`` — CDX-style record index + archive query engine.

* :mod:`.cdx` — binary columnar CDX index (build / merge / save / load),
  :class:`RandomAccessReader` and :func:`verify_index`;
* :mod:`.signature` — per-record n-gram Bloom-style bitmaps, the
  decompress-avoidance pre-filter;
* :mod:`.query` — header-predicate + payload-pattern queries, candidate
  payloads scanned by the ``pattern_scan`` kernel;
* :mod:`.service` — request-queue serving front end with ranked hits.

>>> from repro_torch.index import build_index, QueryEngine, HeaderFilter
>>> index = build_index(["crawl-00.warc.gz"])          # on the GPU
>>> with QueryEngine(index) as engine:
...     hits = engine.search(b"archive", HeaderFilter(status=200))
"""
from . import signature
from .cdx import (CdxEntry, CdxIndex, RandomAccessReader, build_index,
                  verify_index)
from .query import (
    HeaderFilter,
    PatternHit,
    QueryEngine,
    QueryPlan,
    full_scan_regex,
    full_scan_search,
    required_literals,
)
from .service import IndexQueryService, QueryRequest, QueryResponse

__all__ = [
    "CdxEntry",
    "CdxIndex",
    "HeaderFilter",
    "IndexQueryService",
    "PatternHit",
    "QueryEngine",
    "QueryPlan",
    "QueryRequest",
    "QueryResponse",
    "RandomAccessReader",
    "build_index",
    "full_scan_regex",
    "full_scan_search",
    "required_literals",
    "signature",
    "verify_index",
]
