"""The supervised pool under SIGKILL at seeded random moments.

Every shard is dealt down one worker's own task pipe and the parent
records the claim when it sends it, so a worker killed at any moment —
idle in its task read, between reading a task and starting it, in the
middle of a shard or of a result — loses no shard and holds no lock
another worker waits on: the parent re-drives every shard it dealt the
dead worker and has not seen done, each from the results it already
holds. Each case runs a supervised pool over 8 short gzip shards while a
thread SIGKILLs workers at seeded random moments (the first kill while
every worker is still idle in its task read), under a hard limit of its
own, and the ordered results equal the serial ones.

The reference's pool keeps a shared task queue, whose windows these
kills reach, so this runs against the port only.

The parent deals breadth-first: a pool of W workers over W shards gives
each worker one shard, not two shards to each of W/2 workers.
"""
import glob
import os
import signal
import threading
import time

import numpy as np
import pytest

from repro_torch.core.parallel import ParallelWarcPool
from repro_torch.core.reaper import SHM_PREFIX
from repro_torch.core.warc import FastWARCIterator
from repro_torch.data.synth import CorpusSpec, write_corpus

LIMIT_S = 30  # each case, hard
KILLS = 4     # at random moments, after the idle one


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pool_kills")
    paths = []
    for i in range(8):
        p = str(d / f"k{i}.warc.gz")
        write_corpus(p, CorpusSpec(n_pages=6 + i % 3, seed=70 + i), "gzip")
        paths.append(p)
    return paths


def _offsets_slowly(path):
    """Module-level worker: each record's offset and content length,
    slowly enough that kills land inside shards."""
    it = FastWARCIterator(path)
    try:
        for rec in it:
            time.sleep(0.004)
            yield os.path.basename(path), rec.stream_offset, \
                len(rec.content_view())
    finally:
        it.close()


def _killer(pool, rng, stop):
    t0 = time.monotonic()
    for at in sorted(rng.uniform(0.0, 1.5, KILLS)):
        while time.monotonic() - t0 < at:
            if stop.wait(0.005):
                return
        live = [p.pid for p in list(pool._procs) if p.exitcode is None]
        if live:
            os.kill(int(rng.choice(live)), signal.SIGKILL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sigkills_lose_no_shard(shards, seed):
    def expire(signum, frame):
        raise TimeoutError(f"supervised pool still running after {LIMIT_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    stop = threading.Event()
    try:
        want = [r for p in shards for r in _offsets_slowly(p)]
        rng = np.random.default_rng(seed)
        with ParallelWarcPool(_offsets_slowly, workers=2, chunk_size=4,
                              supervise=True, max_respawns=KILLS + 1,
                              poison_kills=KILLS + 2,
                              hang_timeout_s=10) as pool:
            # idle in the task read: nothing is dealt yet
            victim = pool._procs[int(rng.integers(2))]
            os.kill(victim.pid, signal.SIGKILL)
            killer = threading.Thread(target=_killer,
                                      args=(pool, rng, stop))
            killer.start()
            got = list(pool.iter_results(shards, ordered=True))
            stop.set()
            killer.join()
    finally:
        stop.set()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
    assert got == want
    assert victim.exitcode == -signal.SIGKILL  # the idle kill landed
    assert pool.supervisor_stats["quarantined"] == 0
    assert glob.glob(f"/dev/shm/{SHM_PREFIX}-{os.getpid()}-*") == []


def _pid_slowly(item):
    """Module-level worker: the pid that ran the shard, after long
    enough that every shard is dealt before any is done."""
    time.sleep(0.5)
    yield item, os.getpid()


def test_four_workers_take_four_shards():
    with ParallelWarcPool(_pid_slowly, workers=4, supervise=True) as pool:
        got = list(pool.iter_results(range(4), ordered=True))
        pids = {p.pid for p in pool._procs}
    assert [i for i, _ in got] == [0, 1, 2, 3]
    assert {pid for _, pid in got} == pids  # every worker ran one shard
