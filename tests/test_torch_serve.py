"""PyTorch port, the serving runtime (``serve/``, ``runtime/``): the
``rows``/``unrows`` and ``agg``/``join`` ops through the continuous-batching
scheduler, held against the JAX package's ``serve.Scheduler``,
``convert_to_rows`` and the direct pipeline calls on the same payloads, plus
coalescing, admission control, cancellation, deadlines, tenant isolation,
the out-of-memory split and the bucket grid.  Everything
runs on the CPU (``device="cpu"``): the kernels' plain versions."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import serve as jserve
from spark_rapids_jni_tpu.runtime import shapes as jshapes
from spark_rapids_jni_tpu_torch import INT32, Table, serve
from spark_rapids_jni_tpu_torch.models import pipeline
from spark_rapids_jni_tpu_torch.ops import convert_to_rows, kernels
from spark_rapids_jni_tpu_torch.runtime import resilience, shapes, staging

CPU = "cpu"


@pytest.fixture
def sched():
    """An un-started scheduler on the CPU: tests pump :meth:`tick`."""
    s = serve.Scheduler(device=CPU)
    yield s
    s.close()


def _cols(rng, ncols, n):
    return [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
            for _ in range(ncols)]


def _direct_rows(cols):
    """``convert_to_rows`` of the columns through the default route."""
    [b] = convert_to_rows(Table.from_numpy(cols, [INT32] * len(cols),
                                           device=CPU), device=CPU)
    return b.data.numpy().reshape(-1)


def _count_plain_k4(monkeypatch):
    calls = []
    plain = kernels.planes_to_rows_plain

    def counted(planes, start, size):
        calls.append(planes.shape[1])
        return plain(planes, start, size)
    monkeypatch.setattr(kernels, "planes_to_rows_plain", counted)
    return calls


def test_rows_and_unrows_match_jax_scheduler(sched):
    rng = np.random.default_rng(3)
    js = jserve.Scheduler()
    try:
        for ncols, n in [(5, 13), (3, 100), (1, 1)]:
            cols = _cols(rng, ncols, n)
            f = serve.Client(sched, "alice").to_rows(cols)
            jf = jserve.Client(js, "alice").to_rows(cols)
            sched.tick()
            js.tick()
            r, jr = f.result(timeout=30), jf.result(timeout=30)
            assert (r["row_size"], r["num_rows"]) == \
                (jr["row_size"], jr["num_rows"])
            np.testing.assert_array_equal(r["rows"], np.asarray(jr["rows"]))
            np.testing.assert_array_equal(r["rows"], _direct_rows(cols))
            f = serve.Client(sched, "bob").from_rows(r["rows"], ncols)
            jf = jserve.Client(js, "bob").from_rows(jr["rows"], ncols)
            sched.tick()
            js.tick()
            back, jback = f.result(timeout=30), jf.result(timeout=30)
            assert back["num_rows"] == jback["num_rows"] == n
            for got, want, orig in zip(back["columns"], jback["columns"],
                                       cols):
                np.testing.assert_array_equal(got, np.asarray(want))
                np.testing.assert_array_equal(got, orig)
    finally:
        js.close()


def test_same_bucket_requests_one_dispatch(sched, monkeypatch):
    """Eight requests of 9..16 rows share bucket 16: one group, one stage,
    one plain K4 call over 8 x 16 rows, and every answer its own rows."""
    calls = _count_plain_k4(monkeypatch)
    rng = np.random.default_rng(4)
    data = [_cols(rng, 4, 9 + i) for i in range(8)]
    futs = [serve.Client(sched, f"t{i % 3}").to_rows(c)
            for i, c in enumerate(data)]
    assert sched.tick() == 8
    assert calls == [8 * 16]
    assert sched.counters["batches"]["rows"] == 1
    assert sched.counters["coalesced"]["rows"] == 8
    assert sched.total("fallbacks") == 0
    for f, cols in zip(futs, data):
        np.testing.assert_array_equal(f.result(timeout=5)["rows"],
                                      _direct_rows(cols))
    assert sched.healthz()["tenants"] == 3


def test_queue_full_at_depth_cap():
    s = serve.Scheduler(serve.Config(max_depth=4, high_water=4), device=CPU)
    c = serve.Client(s, "alice")
    rng = np.random.default_rng(5)
    futs = [c.to_rows(_cols(rng, 2, 5)) for _ in range(4)]
    with pytest.raises(serve.QueueFull) as e:
        c.to_rows(_cols(rng, 2, 5))
    assert e.value.reason == "full"
    assert s.counters["rejected"]["full"] == 1
    assert s.healthz()["queue_depth"] == 4
    s.close()
    assert all(f.result(timeout=5)["num_rows"] == 5 for f in futs)


def test_shedding_hysteresis():
    """Shedding trips at the high-water mark and clears only when a drain
    takes depth back to the low-water mark (half of it)."""
    s = serve.Scheduler(serve.Config(max_depth=16, high_water=4,
                                     max_batch=1), device=CPU)
    c = serve.Client(s, "alice")
    rng = np.random.default_rng(6)
    for _ in range(4):
        c.to_rows(_cols(rng, 1, 3))
    assert s.healthz()["shedding"]
    with pytest.raises(serve.QueueFull) as e:
        c.to_rows(_cols(rng, 1, 3))
    assert e.value.reason == "shedding"
    s.tick()                                  # depth 3 > low water 2
    assert s.healthz()["shedding"]
    s.tick()                                  # depth 2: released
    assert not s.healthz()["shedding"]
    c.to_rows(_cols(rng, 1, 3))
    s.close()
    assert s.healthz()["queue_depth"] == 0
    with pytest.raises(serve.QueueFull) as e:
        c.to_rows(_cols(rng, 1, 3))
    assert e.value.reason == "closed"


def test_cancelled_future_is_dropped(sched, monkeypatch):
    calls = _count_plain_k4(monkeypatch)
    rng = np.random.default_rng(7)
    data = [_cols(rng, 3, 10 + i) for i in range(3)]
    c = serve.Client(sched, "alice")
    futs = [c.to_rows(cols) for cols in data]
    assert futs[1].cancel()
    sched.tick()
    assert futs[1].cancelled()
    assert sched.counters["cancelled"]["rows"] == 1
    assert calls == [8 * 16]                  # two live requests, 8 slots
    for i in (0, 2):
        np.testing.assert_array_equal(futs[i].result(timeout=5)["rows"],
                                      _direct_rows(data[i]))


def test_expired_deadline_is_never_dispatched(sched, monkeypatch):
    calls = _count_plain_k4(monkeypatch)
    rng = np.random.default_rng(8)
    f = sched.submit("alice", "rows", columns=_cols(rng, 2, 7),
                     deadline_s=1e-3)
    time.sleep(0.01)
    sched.tick()
    with pytest.raises(resilience.DeadlineExceeded):
        f.result(timeout=5)
    assert calls == []
    assert sched.counters["deadline"]["rows"] == 1
    assert sched.total("batches") == 0


def test_client_admission_retry_under_deadline():
    """A full queue is retried with backoff until a drain frees it; with
    no drain the client's deadline expires."""
    s = serve.Scheduler(serve.Config(max_depth=2, high_water=2), device=CPU)
    c = serve.Client(s, "alice")
    rng = np.random.default_rng(9)
    first = [c.to_rows(_cols(rng, 1, 4)) for _ in range(2)]
    with pytest.raises(resilience.DeadlineExceeded):
        c.to_rows(_cols(rng, 1, 4), deadline_s=0.05)
    timer = threading.Timer(0.05, s.tick)
    timer.start()
    late = c.to_rows(_cols(rng, 1, 4), deadline_s=10)
    timer.join(5)
    assert not timer.is_alive()
    s.tick()
    assert all(f.result(timeout=5)["num_rows"] == 4 for f in first + [late])
    s.close()


def test_group_failure_is_isolated(sched, monkeypatch):
    """A kernel that fails for every group of more than one request (its
    pad slots are zeros, a request's random columns are not): each request
    is retried alone on the same kernel and answered."""
    op = serve.ops.get("rows")
    kernel = op.kernel

    def failing(sig, kb):
        def run(cols):
            if int(cols.flatten(1).any(1).sum()) > 1:
                raise RuntimeError("injected group failure")
            return kernel(sig, kb)(cols)
        return run
    monkeypatch.setattr(op, "kernel", failing)
    rng = np.random.default_rng(10)
    data = [_cols(rng, 3, 20 + i) for i in range(3)]
    futs = [serve.Client(sched, f"t{i}").to_rows(cols)
            for i, cols in enumerate(data)]
    sched.tick()
    for f, cols in zip(futs, data):
        np.testing.assert_array_equal(f.result(timeout=5)["rows"],
                                      _direct_rows(cols))
    assert sched.counters["fallbacks"]["rows"] == 3
    assert sched.total("batches") == 0
    assert sched.total("tick_errors") == 0


def test_out_of_memory_splits_on_the_request_axis(sched, monkeypatch):
    """A kernel out of memory at 16 slots: the group halves into two
    8-slot dispatches whose merged outputs equal an unsplit run's bytes."""
    rng = np.random.default_rng(11)
    data = [_cols(rng, 5, 40 + i) for i in range(16)]
    c = serve.Client(sched, "alice")
    futs = [c.to_rows(cols) for cols in data]
    sched.tick()
    want = [f.result(timeout=5)["rows"] for f in futs]

    op = serve.ops.get("rows")
    kernel = op.kernel
    slots = []

    def oom_at_16(sig, kb):
        slots.append(kb)
        if kb >= 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return kernel(sig, kb)
    monkeypatch.setattr(op, "kernel", oom_at_16)
    futs = [c.to_rows(cols) for cols in data]
    sched.tick()
    assert slots == [16, 8, 8]
    for f, w in zip(futs, want):
        np.testing.assert_array_equal(f.result(timeout=5)["rows"], w)
    assert sched.total("fallbacks") == 0
    assert sched.counters["batches"]["rows"] == 2


def test_close_drains_or_fails_pending():
    rng = np.random.default_rng(12)
    s = serve.Scheduler(device=CPU)
    futs = [serve.Client(s, "alice").to_rows(_cols(rng, 2, 9 + i))
            for i in range(5)]
    s.close(drain=True)
    assert [f.result(timeout=5)["num_rows"] for f in futs] == \
        list(range(9, 14))
    s.close()                                 # idempotent
    s = serve.Scheduler(device=CPU)           # never started, no drain
    futs = [serve.Client(s, "alice").to_rows(_cols(rng, 2, 9))
            for _ in range(3)]
    s.close(drain=False)
    for f in futs:
        with pytest.raises(serve.QueueFull):
            f.result(timeout=5)


def test_threaded_loop_answers_every_request():
    """Eight client threads against the background loop, the interpreter
    switching threads as often as it can: every future answered with its
    own rows, and no count lost (the counters are shared with the loop)."""
    rng = np.random.default_rng(13)
    nthreads, per = 8, 8
    data = [[_cols(rng, 3, int(n)) for n in rng.integers(1, 300, per)]
            for _ in range(nthreads)]
    results = [[None] * per for _ in range(nthreads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with serve.Scheduler(device=CPU) as s:
            def client(t):
                c = serve.Client(s, f"tenant{t}")
                futs = [c.to_rows(cols) for cols in data[t]]
                for i, f in enumerate(futs):
                    results[t][i] = f.result(timeout=30)["rows"]
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    for t in range(nthreads):
        for cols, rows in zip(data[t], results[t]):
            np.testing.assert_array_equal(rows, _direct_rows(cols))
    assert s.total("tick_errors") == 0 and s.total("fallbacks") == 0
    assert s.counters["requests"]["rows"] == nthreads * per
    assert s.total("coalesced") == nthreads * per
    assert s.healthz()["served"] == nthreads * per


def _padded(a, b):
    out = np.zeros(b, a.dtype)
    out[:len(a)] = a
    return torch.from_numpy(out)


def test_agg_and_join_match_jax_scheduler_and_direct_calls(sched):
    """Requests of several tenants in one tick (agg: two buckets, one of
    them coalescing three clients; join: build sides padded with dead rows,
    a live build key equal to 0 beside the zero pad), each against the JAX
    scheduler's answer and against the direct call on its padded rows."""
    rng = np.random.default_rng(21)
    js = jserve.Scheduler()
    try:
        aggs = [(rng.integers(-6, 6, n).astype(np.int32),
                 rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32), mg)
                for n, mg in ((37, 8), (33, 8), (40, 8), (200, 4))]
        futs = [serve.Client(sched, f"t{i}").aggregate(k, v, mg)
                for i, (k, v, mg) in enumerate(aggs)]
        jfuts = [jserve.Client(js, f"t{i}").aggregate(k, v, mg)
                 for i, (k, v, mg) in enumerate(aggs)]
        assert sched.tick() == len(aggs)
        js.tick()
        for (k, v, mg), f, jf in zip(aggs, futs, jfuts):
            r, jr = f.result(timeout=30), jf.result(timeout=30)
            b = shapes.bucket_rows(len(k))
            direct = pipeline.hash_aggregate_sum(
                _padded(k, b), _padded(v, b),
                _padded(np.ones(len(k), bool), b), mg)
            for name, d in zip(("group_keys", "sums", "have"), direct):
                np.testing.assert_array_equal(r[name], np.asarray(jr[name]))
                np.testing.assert_array_equal(r[name], d.numpy())
            assert r["num_groups"] == jr["num_groups"] == int(direct[3])
        joins = []
        for m, n in ((21, 45), (9, 30), (3, 64)):
            bk = rng.permutation(np.arange(1, 100))[:m].astype(np.int32)
            bk[0] = 0                       # a live key equal to the pad
            pk = rng.integers(0, 100, n).astype(np.int32)
            pk[:2] = 0
            joins.append((bk, rng.integers(1, 1000, m).astype(np.int32), pk))
        futs = [serve.Client(sched, f"t{i}").join(*j)
                for i, j in enumerate(joins)]
        jfuts = [jserve.Client(js, f"t{i}").join(*j)
                 for i, j in enumerate(joins)]
        sched.tick()
        js.tick()
        for (bk, bp, pk), f, jf in zip(joins, futs, jfuts):
            r, jr = f.result(timeout=30), jf.result(timeout=30)
            bm, bn = shapes.bucket_rows(len(bk)), shapes.bucket_rows(len(pk))
            pay, matched = pipeline.sort_merge_join_live(
                _padded(bk, bm), _padded(bp, bm),
                _padded(np.ones(len(bk), bool), bm), _padded(pk, bn))
            for name, d in (("payload", pay), ("matched", matched)):
                np.testing.assert_array_equal(r[name], np.asarray(jr[name]))
                np.testing.assert_array_equal(r[name], d.numpy()[:len(pk)])
            assert r["matched"][pk == 0].all()
    finally:
        js.close()


def test_bucket_grid_matches_jax():
    ns = range(0, 70_001)
    assert [shapes.bucket_rows(n) for n in ns] == \
        [jshapes.bucket_rows(n) for n in ns]
    assert [shapes.split_bucket(n) for n in ns] == \
        [jshapes.split_bucket(n) for n in ns]
    assert [shapes.bucket_width(w) for w in range(0, 5000)] == \
        [jshapes.bucket_width(w) for w in range(0, 5000)]
    for f in (1.5, 3.0):
        assert [shapes.bucket_rows(n, f) for n in range(0, 5000)] == \
            [jshapes.bucket_rows(n, f) for n in range(0, 5000)]


def test_staging_round_trip_one_blob():
    rng = np.random.default_rng(14)
    bufs = [rng.integers(-9, 9, (3, 5)).astype(np.int32),
            rng.random(7) > 0.5, np.zeros((0, 4), np.int64),
            rng.integers(0, 255, 13).astype(np.uint8)]
    staged = staging.stage_arrays(bufs, CPU)
    assert len({t.untyped_storage().data_ptr() for t in staged}) == 1
    back = staging.fetch_arrays(staged)
    for b, s, h in zip(bufs, staged, back):
        assert tuple(s.shape) == b.shape and h.dtype == b.dtype
        np.testing.assert_array_equal(h, b)
    assert staging._blob_len(60 + 7 + 13 + 7) == 128


def test_ops_reject_malformed_and_unported(sched):
    c = serve.Client(sched, "alice")
    with pytest.raises(ValueError):
        c.to_rows([])
    with pytest.raises(ValueError):
        c.to_rows([np.arange(3), np.arange(4)])
    with pytest.raises(ValueError):
        c.from_rows(np.zeros(7, np.uint8), 1)
    with pytest.raises(ValueError):
        sched.submit("alice", "nope")
    with pytest.raises(ValueError):
        c.aggregate([1, 2], [1])
    with pytest.raises(ValueError):
        c.aggregate([], [])
    with pytest.raises(ValueError):
        c.aggregate([1.5], [1])
    with pytest.raises(ValueError):
        sched.submit("alice", "agg", keys=[1], values=[1], extra=1)
    with pytest.raises(ValueError):
        c.join([1, 2], [1], [1])
    with pytest.raises(ValueError):
        sched.submit("alice", "join", build_keys=[1], build_payload=[1],
                     probe_keys=[[1]])
    assert serve.ops.names() == ["agg", "join", "rows", "unrows"]
    assert resilience.classify(torch.cuda.OutOfMemoryError("x")) == \
        resilience.RESOURCE
    assert resilience.classify(ValueError("x")) == resilience.DETERMINISTIC


def test_scheduler_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Scheduler()
    assert serve.Scheduler(device=CPU).device == torch.device(CPU)
