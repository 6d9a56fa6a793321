"""Sharded, prefetching, exactly-resumable WARC→token training loader.

The host-side input pipeline of training (a copy of the reference's
``repro.data.loader`` on the port's pipeline and pool):

* **sharding** — shard files are assigned round-robin by
  ``host_id mod n_hosts``;
* **prefetch** — a daemon thread parses/tokenizes/packs ahead into a
  bounded queue, overlapping host CPU with device compute;
* **exact resume** — the cursor (shard index, documents consumed in the
  current shard, packer remainder, rows not yet emitted) is exposed via
  :meth:`WarcTokenLoader.state` and restored via
  :meth:`WarcTokenLoader.restore`; the train loop stores it in every
  checkpoint (``repro_torch.train.checkpoint`` extras). Under prefetch it
  is the cursor just past the last batch handed to the consumer, not the
  prefetch thread's: the reference's ``state()`` reads the thread's
  cursor, up to ``prefetch`` batches ahead, so a resume from its
  checkpoint skips the batches that were queued (ROADMAP §3, F6);
* **multi-core parse** — ``workers=N`` runs WARC parse + HTML→text +
  tokenization for the shards *ahead of the cursor* in N worker processes
  (:class:`repro_torch.core.parallel.ParallelWarcPool`, ordered mode),
  while the packer — the only stateful stage — stays in this process, so
  the cursor semantics and the batches are bit-identical to the serial
  path. A process that holds a CUDA context (the trainer on the card)
  starts the workers by ``forkserver``; the worker function is
  module-level, so it pickles there.

Batches are host ``int32`` numpy arrays; the trainer moves them to the
device.
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch.core.pipeline import iter_documents
from .packing import SequencePacker, pad_batch
from .tokenizer import encode_document

__all__ = ["WarcTokenLoader", "split_batch"]


def _tokenized_docs(path: str, *, min_length: int,
                    readahead: bool | None = None):
    """Worker-side shard stage: parse → extract → tokenize (module-level
    so the process pool can pickle it)."""
    for doc in iter_documents(path, min_length=min_length,
                              readahead=readahead):
        yield encode_document(doc.text)


class WarcTokenLoader:
    def __init__(self, shard_paths: list[str], *, batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1, min_doc_len: int = 64,
                 prefetch: int = 4, loop: bool = True,
                 workers: int = 0, readahead: bool | None = None) -> None:
        self.all_shards = list(shard_paths)
        self.my_shards = [p for i, p in enumerate(self.all_shards)
                          if i % n_hosts == host_id]
        if not self.my_shards:
            raise ValueError("no shards assigned to this host")
        self.batch = batch
        self.seq_len = seq_len
        self.min_doc_len = min_doc_len
        self.loop = loop
        self.prefetch = prefetch
        self.workers = workers
        # member-decode readahead inside each shard parse (None = auto);
        # close() joins those decoders via the iter_documents teardown
        self.readahead = readahead
        self._pool = None
        self._packer = SequencePacker(seq_len)
        self._rows: list[np.ndarray] = []   # packed, not yet emitted
        self._shard_idx = 0
        self._docs_consumed = 0
        self._epoch = 0
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # the cursor just past the last batch the prefetching iterator
        # handed out (None: no prefetched batch handed out since restore)
        self._handed: dict | None = None

    # -- checkpointable cursor -------------------------------------------
    def _cursor(self) -> dict:
        return {"shard_idx": self._shard_idx,
                "docs_consumed": self._docs_consumed,
                "epoch": self._epoch,
                "packer": self._packer.state(),
                "rows": [r.tolist() for r in self._rows]}

    def state(self) -> dict:
        """The cursor after the last batch the consumer took: restoring
        it resumes with the next batch, exactly."""
        return self._handed if self._handed is not None else self._cursor()

    def restore(self, state: dict) -> None:
        self._handed = None
        self._shard_idx = state["shard_idx"]
        self._docs_consumed = state["docs_consumed"]
        self._epoch = state.get("epoch", 0)
        self._packer.restore(state["packer"])
        self._rows = [np.asarray(r, np.int32) for r in state.get("rows", [])]

    # -- synchronous batch generator --------------------------------------
    def _emit(self, ids: np.ndarray) -> Iterator[np.ndarray]:
        """Pack one document's tokens; yield every batch that completes."""
        self._rows.extend(self._packer.feed(ids))
        while len(self._rows) >= self.batch:
            out = np.stack(self._rows[:self.batch])
            self._rows = self._rows[self.batch:]
            yield out

    def batches(self) -> Iterator[np.ndarray]:
        """Yield [batch, seq_len+1] int32 arrays (row = inputs+labels).

        The not-yet-emitted row backlog lives on the object (``_rows``) so
        :meth:`state` snapshots taken between batches resume exactly.
        With ``workers > 0`` the per-shard parse/tokenize stages run in
        worker processes; document order, cursor updates and emitted
        batches are identical to the serial path.
        """
        if self.workers > 0:
            yield from self._batches_parallel()
            return
        while not self._stop.is_set():
            shard = self.my_shards[self._shard_idx % len(self.my_shards)]
            skip = self._docs_consumed
            for n_doc, doc in enumerate(
                    iter_documents(shard, min_length=self.min_doc_len,
                                   readahead=self.readahead)):
                if self._stop.is_set():  # close() must not wait a shard out
                    return
                if n_doc < skip:
                    continue
                self._docs_consumed = n_doc + 1
                yield from self._emit(encode_document(doc.text))
            self._shard_idx += 1
            self._docs_consumed = 0
            if self._shard_idx % len(self.my_shards) == 0:
                self._epoch += 1
                if not self.loop:
                    if self._rows:
                        yield pad_batch(self._rows, self.batch, self.seq_len)
                        self._rows = []
                    return

    # -- process-parallel shard parsing ------------------------------------
    def _shard_paths_from(self, start: int) -> Iterator[str]:
        """Shard path sequence the serial loop would visit from ``start``:
        round-robin forever when looping, else to the next epoch boundary."""
        n = len(self.my_shards)
        if self.loop:
            k = start
            while True:
                yield self.my_shards[k % n]
                k += 1
        else:
            for k in range(start, (start // n + 1) * n):
                yield self.my_shards[k % n]

    def _batches_parallel(self) -> Iterator[np.ndarray]:
        from repro_torch.core.parallel import ParallelWarcPool

        n = len(self.my_shards)
        fn = functools.partial(_tokenized_docs, min_length=self.min_doc_len,
                               readahead=self.readahead)
        pool = ParallelWarcPool(fn, workers=self.workers)
        self._pool = pool
        try:
            skip = self._docs_consumed
            n_doc = 0  # position within the current shard (incl. skipped)
            for event in pool.iter_events(
                    self._shard_paths_from(self._shard_idx), ordered=True):
                if self._stop.is_set():  # close() must not wait a shard out
                    return
                if event[0] == "chunk":
                    for ids in event[2]:
                        if n_doc >= skip:
                            self._docs_consumed = n_doc + 1
                            yield from self._emit(ids)
                        n_doc += 1
                    continue
                # shard boundary
                self._shard_idx += 1
                self._docs_consumed = 0
                skip = 0
                n_doc = 0
                if self._shard_idx % n == 0:
                    self._epoch += 1
                    if not self.loop:
                        break
            if not self.loop and self._rows:
                yield pad_batch(self._rows, self.batch, self.seq_len)
                self._rows = []
        finally:
            self._pool = None
            pool.close()

    # -- prefetching iterator ----------------------------------------------
    def __iter__(self) -> Iterator[np.ndarray]:
        if self.prefetch <= 0:
            yield from self.batches()
            return
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()

        def worker():
            try:
                for batch in self.batches():
                    item = (batch, self._cursor())
                    # bounded put that stays responsive to close()
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            finally:
                try:
                    self._queue.put_nowait(None)
                except queue.Full:
                    pass

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        while True:
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive():
                    return
                continue
            if item is None:
                return
            batch, self._handed = item
            yield batch

    def close(self) -> None:
        """Stop the prefetch thread (and any worker pool) and join it.

        ``batches()`` polls the stop flag per document/event, so the join
        normally returns within one document's parse time; the deadline
        is a backstop (the thread is a daemon either way).
        """
        self._stop.set()
        thread = self._thread
        if thread is not None:
            deadline = time.monotonic() + 10.0
            while thread.is_alive() and time.monotonic() < deadline:
                if self._queue is not None:
                    try:  # unblock a producer waiting on a full queue
                        self._queue.get_nowait()
                    except queue.Empty:
                        pass
                thread.join(timeout=0.05)
            self._thread = None
        pool = self._pool
        if pool is not None:
            pool.close()
            self._pool = None


def split_batch(batch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, S+1] row -> (inputs [B, S], labels [B, S])."""
    return batch[:, :-1], batch[:, 1:]
