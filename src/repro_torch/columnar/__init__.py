"""``repro_torch.columnar`` — derived columnar store: parse once, scan native.

:mod:`.codec` is the generic column codec (shared with the CDX index),
:mod:`.store` the versioned mmap-backed ``.repcol`` format and reader,
:mod:`.derive` the parse-once derivation, whose digest and signature
columns come from the fused kernel on the device.

>>> from repro_torch.columnar import derive
>>> from repro_torch.index import IndexQueryService, QueryEngine
>>> store = derive(["crawl-00.warc.gz"], "crawl.repcol")   # on the GPU
>>> engine = QueryEngine.from_store(store)
>>> svc = IndexQueryService(engine.index, engine=engine)
"""
from .codec import ArrayCursor, ColumnFile, ColumnWriter, pack_arrays
from .derive import derive, parse_warc_date
from .store import ColumnStore, RowGroupSpec, pack_plan

__all__ = ["ArrayCursor", "ColumnFile", "ColumnStore", "ColumnWriter",
           "RowGroupSpec", "derive", "pack_arrays", "pack_plan",
           "parse_warc_date"]
