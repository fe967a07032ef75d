"""The port's batch stream (hivedscheduler_tpu_torch.parallel.data) against
the JAX package's: the same dataset and seed must give the same batches bit
for bit, through ``skip`` and a ``to_dict``/``from_dict`` resume."""

import json
import threading

import numpy as np
import pytest
import torch

from hivedscheduler_tpu.parallel import data as jdata
from hivedscheduler_tpu_torch.parallel import data as tdata

torch.set_num_threads(1)

VOCAB, BATCH, SEQ = 96, 4, 32


def _datasets(size=5000):
    return (jdata.synthetic_dataset(VOCAB, size=size),
            tdata.synthetic_dataset(VOCAB, size=size))


def test_sample_matches_jax_with_wraparound():
    jds, tds = _datasets(size=200)  # windows wrap around the corpus end
    for rows in (slice(None), slice(1, 3)):
        a = jds.sample(np.random.default_rng(3), BATCH, SEQ, row_slice=rows)
        b = tds.sample(np.random.default_rng(3), BATCH, SEQ, row_slice=rows)
        assert b.dtype == np.int32 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_host_batches_match_jax():
    jds, tds = _datasets()
    for kw in (dict(seed=1), dict(seed=2, start_step=5),
               dict(seed=1, process_index=1, process_count=2)):
        ja = jdata.host_batches(jds, BATCH, SEQ, **kw)
        tb = tdata.host_batches(tds, BATCH, SEQ, **kw)
        for _ in range(3):
            np.testing.assert_array_equal(next(ja), next(tb))
    with pytest.raises(ValueError):
        next(tdata.host_batches(tds, 3, SEQ, process_count=2))


def test_checkpointable_stream_skip_and_resume_match_jax():
    jds, tds = _datasets()
    ja = jdata.CheckpointableBatches(jds, BATCH, SEQ, seed=7)
    tb = tdata.CheckpointableBatches(tds, BATCH, SEQ, seed=7)
    for _ in range(2):
        np.testing.assert_array_equal(next(ja), next(tb))
    ja.skip(3)
    tb.skip(3)
    assert ja.to_dict() == tb.to_dict()
    # resume from the JSON state of record, in each package from the other's
    state = json.loads(json.dumps(tb.to_dict()))
    ta = tdata.CheckpointableBatches.from_dict(state, tds, BATCH, SEQ)
    jb = jdata.CheckpointableBatches.from_dict(json.loads(json.dumps(ja.to_dict())),
                                               jds, BATCH, SEQ)
    for _ in range(3):
        want = next(ja)
        np.testing.assert_array_equal(next(tb), want)
        np.testing.assert_array_equal(next(ta), want)
        np.testing.assert_array_equal(next(jb), want)
    assert ta.step == tb.step == ja.step == 8


def test_skip_matches_next():
    _, tds = _datasets()
    a = tdata.CheckpointableBatches(tds, BATCH, SEQ, seed=2)
    b = tdata.CheckpointableBatches(tds, BATCH, SEQ, seed=2)
    for _ in range(2):
        next(a)
    b.skip(2)
    np.testing.assert_array_equal(next(a), next(b))


def test_host_shards_and_epoch_match_jax():
    jds, tds = _datasets(size=1000)
    kw = dict(process_index=1, process_count=2, seed=4)
    ja = jdata.CheckpointableBatches(jds, BATCH, SEQ, **kw)
    tb = tdata.CheckpointableBatches(tds, BATCH, SEQ, **kw)
    for _ in range(10):
        np.testing.assert_array_equal(next(ja), next(tb))
    assert tb.epoch == ja.epoch == 10 * BATCH * SEQ // 1000
    with pytest.raises(ValueError):
        tdata.CheckpointableBatches(tds, 3, SEQ, process_count=2)


def test_loader_state_pins_dataclass_fields():
    import dataclasses

    names = [f.name for f in dataclasses.fields(tdata.LoaderState)]
    assert names == [f.name for f in dataclasses.fields(jdata.LoaderState)]
    assert list(tdata.LoaderState().to_dict()) == names
    with pytest.raises(ValueError) as err:
        tdata.LoaderState.from_dict({"seed": 0, "cursor": 3})
    assert "unknown LoaderState fields" in str(err.value)


def test_prefetch_preserves_order():
    src = [np.full((2,), i) for i in range(7)]
    got = list(tdata.prefetch(iter(src), depth=2))
    assert [int(x[0]) for x in got] == list(range(7))
    assert [int(x[0]) for x in tdata.prefetch(iter(src), depth=0)] == list(range(7))


def test_prefetch_reraises_a_producer_error_and_leaves_no_worker():
    def producer():
        yield np.zeros(2)
        raise RuntimeError("disk gone")

    it = tdata.prefetch(producer(), depth=2)
    next(it)
    with pytest.raises(RuntimeError) as err:
        next(it)
    assert "disk gone" in str(err.value)
    worker = tdata._last_prefetch_worker
    worker.join(timeout=5.0)
    assert not worker.is_alive()


def test_prefetch_close_with_a_full_queue_reaps_the_worker():
    def endless():
        i = 0
        while True:
            yield np.full((2,), i)
            i += 1

    it = tdata.prefetch(endless(), depth=2)
    next(it)
    it.close()  # the worker is blocked on a full queue
    worker = tdata._last_prefetch_worker
    worker.join(timeout=5.0)
    assert not worker.is_alive()


def test_prefetch_stop_event_wakes_a_blocked_consumer():
    hang = threading.Event()

    def hung():
        hang.wait(10.0)
        yield np.zeros(2)

    stop = threading.Event()
    it = tdata.prefetch(hung(), depth=2, stop=stop)
    threading.Timer(0.2, stop.set).start()
    assert list(it) == []  # woke on stop, without a batch
    hang.set()
    worker = tdata._last_prefetch_worker
    worker.join(timeout=5.0)
    assert not worker.is_alive()
