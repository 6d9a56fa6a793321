"""Training data parity: ``repro_torch``'s packing, text pipeline and token
loader vs the JAX reference, exactly.

The same seeded gzip shards (written once by the port's synth) and the
same numpy-seeded token arrays go through both packages; rows, texts,
documents and batches must be equal bit for bit — serially, with the
pool (``iter_documents_parallel``, ``WarcTokenLoader(workers=2)``) and
after ``state()``/``restore()``, across packages both ways. One case
pins the port's cursor under prefetch: ``state()`` is the position just
past the last batch handed out, so a restore resumes exactly.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import pipeline as port_pipe
from repro_torch.core.parallel import (iter_documents_parallel,
                                       iter_records_parallel)
from repro_torch.data import loader as port_loader
from repro_torch.data import packing as port_packing
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.testing.faults import corrupt_warc


@pytest.fixture(scope="module")
def ref():
    from repro.core import parallel, pipeline
    from repro.data import loader, packing

    return SimpleNamespace(pipeline=pipeline, loader=loader, packing=packing,
                           parallel=parallel)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train_data")
    paths = []
    for i in range(4):
        p = str(d / f"s{i}.warc.gz")
        write_corpus(p, CorpusSpec(n_pages=25, seed=i), "gzip")
        paths.append(p)
    return paths


def _docs(it) -> list:
    return [(d.uri, d.text, d.record_offset) for d in it]


def _damaged(src: str, dst: str, seed: int) -> str:
    with open(src, "rb") as f:
        data, _ = corrupt_warc(f.read(), fraction=0.05, seed=seed)
    with open(dst, "wb") as f:
        f.write(data)
    return dst


def test_packing_matches_reference(ref):
    rng = np.random.default_rng(0)
    a, b = port_packing.SequencePacker(37), ref.packing.SequencePacker(37)
    for n in rng.integers(1, 90, 30):
        toks = rng.integers(3, 259, n).astype(np.int32)
        toks[-1] = 2  # EOS
        got, want = a.feed(toks), b.feed(toks)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(port_packing.segment_ids(g),
                                          ref.packing.segment_ids(w))
        assert a.state() == b.state()
    rows = [rng.integers(0, 259, k).astype(np.int32) for k in (38, 20, 5)]
    np.testing.assert_array_equal(port_packing.pad_batch(rows, 4, 37),
                                  ref.packing.pad_batch(rows, 4, 37))
    fresh = port_packing.SequencePacker(37)
    fresh.restore(b.state())
    assert fresh.state() == b.state()


def test_text_pipeline_matches_reference(ref, shards, tmp_path):
    html = (b"<html><head><style>p{x}</style><script>var a=1;</script></head>"
            b"<body><p>caf&amp;&eacute; &lt;b&gt; &quot;q&quot; &#39;s"
            b"&nbsp;x</p>\n\t<a href='https://Ex.org/a'>l</a>"
            b"<a href=http://b.net/c?d>m</a></body></html>")
    assert port_pipe.html_to_text(html) == ref.pipeline.html_to_text(html)
    assert port_pipe.html_to_text(memoryview(html)) == \
        ref.pipeline.html_to_text(html)
    assert port_pipe.extract_links(html) == ref.pipeline.extract_links(html)
    for uri in (b"https://Ex.org/a", "http://b.net", "plain/host"):
        assert port_pipe.host_of(uri) == ref.pipeline.host_of(uri)
    for path in shards[:2]:
        for kw in ({}, {"min_length": 0, "status_ok_only": False}):
            assert _docs(port_pipe.iter_documents(path, **kw)) == \
                _docs(ref.pipeline.iter_documents(path, **kw))
    damaged = _damaged(shards[0], str(tmp_path / "d.warc.gz"), 1)
    assert _docs(port_pipe.iter_documents(damaged, tolerant=True)) == \
        _docs(ref.pipeline.iter_documents(damaged, tolerant=True))
    got = port_pipe.web_graph_from_warcs(shards, workers=2)
    want = ref.pipeline.web_graph_from_warcs(shards, workers=0)
    assert got["hosts"] == want["hosts"]
    np.testing.assert_array_equal(got["edge_src"], want["edge_src"])
    np.testing.assert_array_equal(got["edge_dst"], want["edge_dst"])


def test_parallel_documents_and_tolerant_records(ref, shards, tmp_path):
    want = _docs(d for p in shards for d in ref.pipeline.iter_documents(p))
    for transport in ("shm", "pickle"):
        assert _docs(iter_documents_parallel(
            shards, workers=2, ordered=True, transport=transport)) == want
    assert sorted(_docs(iter_documents_parallel(shards, workers=2))) == \
        sorted(want)
    assert _docs(iter_documents_parallel(shards, workers=0)) == want
    damaged = _damaged(shards[1], str(tmp_path / "r.warc.gz"), 2)
    items = [shards[0], damaged]

    def key(recs):
        return [(r.stream_offset, bytes(r.content_view())) for r in recs]

    assert key(iter_records_parallel(items, workers=2, ordered=True,
                                     tolerant=True)) == \
        key(ref.parallel.iter_records_parallel(items, workers=0,
                                               tolerant=True))


def _take(gen, n):
    return [next(gen).copy() for _ in range(n)]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_reference(ref, shards, workers):
    """Eight batches over shard boundaries, then one loader's cursor
    restored into the other package's loader, both ways."""
    kw = dict(batch=4, seq_len=128, prefetch=0)
    mine = port_loader.WarcTokenLoader(shards, workers=workers, **kw)
    theirs = ref.loader.WarcTokenLoader(shards, **kw)
    g_mine, g_theirs = mine.batches(), theirs.batches()
    for a, b in zip(_take(g_mine, 8), _take(g_theirs, 8)):
        np.testing.assert_array_equal(a, b)
    snap_theirs, snap_mine = theirs.state(), mine.state()
    assert snap_mine == snap_theirs
    want = _take(g_theirs, 3)
    g_mine.close()
    mine.close()
    resumed = port_loader.WarcTokenLoader(shards, workers=workers, **kw)
    resumed.restore(snap_theirs)
    for a, b in zip(_take(resumed.batches(), 3), want):
        np.testing.assert_array_equal(a, b)
    resumed.close()
    back = ref.loader.WarcTokenLoader(shards, **kw)
    back.restore(snap_mine)
    for a, b in zip(_take(back.batches(), 3), want):
        np.testing.assert_array_equal(a, b)
    x, y = port_loader.split_batch(want[0])
    rx, ry = ref.loader.split_batch(want[0])
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def test_prefetch_cursor_resumes_exactly(shards):
    sync = port_loader.WarcTokenLoader(shards, batch=4, seq_len=64,
                                       prefetch=0)
    want = _take(sync.batches(), 9)
    pre = port_loader.WarcTokenLoader(shards, batch=4, seq_len=64,
                                      prefetch=4)
    it = iter(pre)
    got = [next(it).copy() for _ in range(5)]
    snap = pre.state()
    pre.close()
    resumed = port_loader.WarcTokenLoader(shards, batch=4, seq_len=64,
                                          prefetch=4)
    resumed.restore(snap)
    it = iter(resumed)
    got += [next(it).copy() for _ in range(4)]
    resumed.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
