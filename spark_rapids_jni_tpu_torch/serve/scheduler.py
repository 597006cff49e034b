"""Continuous-batching scheduler: ticks, one kernel launch a group, tenant
isolation.

The PyTorch counterpart of ``spark_rapids_jni_tpu.serve.scheduler``.  One
background thread runs the tick loop: each tick drains the request queue
into coalescing groups (``(op, shape-bucket signature)``), and for every
group stages ONE mega-batch blob host -> device
(:func:`runtime.staging.stage_arrays`), runs the op's kernel once over every
request of the group, fetches every output in ONE transfer
(:func:`staging.fetch_arrays`), and hands each request its slice.  K
concurrent same-bucket requests therefore cost one call of the op's kernel
per tick (one launch for the row ops).

Tenant isolation under faults: a failed group dispatch falls back to
per-request execution (each request its own single-slot batch, on the same
kernel), so one tenant's poisoned batch costs the other tenants in the group
at most a retry; only the faulty request's future carries the error.  A
resource failure (a CUDA out-of-memory error) first halves the group along
its request axis and merges the slot-major outputs byte for byte.  A request
whose deadline expires while queued is dropped before staging with
:class:`runtime.resilience.DeadlineExceeded` and never dispatched.

Futures follow the executor protocol: the tick claims each request with
``Future.set_running_or_notify_cancel()`` before dispatch, so a client that
cancels a still-queued future just drops it from the batch, and every
resolution goes through a guard that tolerates already-resolved futures.
The loop itself survives any unexpected tick error.

Counters (:attr:`Scheduler.counters`, by op unless noted): ``requests``,
``batches`` (group dispatches), ``coalesced`` (requests served by them),
``fallbacks`` (requests retried alone after a failed group), ``cancelled``,
``deadline``, ``rejected`` (by reason) and ``tick_errors`` (by op, ``""``
for the loop).  The spans, the metric families, the flight recorder,
memory watch, the cost ledger and the SLO shedding of the JAX package wait
for the port's observability layer (``ROADMAP.md`` queue 1, item 13).

Settings (all overridable via :class:`Config`):

- ``SRJ_TPU_SERVE_DEPTH``: queue depth cap (default 256)
- ``SRJ_TPU_SERVE_TICK``: tick interval seconds (default 0.002)
- ``SRJ_TPU_SERVE_MAX_TENANTS``: tenant-label cardinality cap (64)
- ``SRJ_TPU_SERVE_HIWATER``: shed high-water mark (default 3/4 depth)
- ``SRJ_TPU_SERVE_MAX_BATCH``: max requests drained per tick (default 0 =
  unlimited)
- ``SRJ_TPU_SERVE_DEADLINE_MS``: default per-request deadline (0 =
  unbounded); ``deadline_s`` of a submission overrides it
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from spark_rapids_jni_tpu_torch.runtime import resilience as _resilience
from spark_rapids_jni_tpu_torch.runtime import shapes, staging
from spark_rapids_jni_tpu_torch.serve import ops as serve_ops
from spark_rapids_jni_tpu_torch.serve.queue import (
    QueueFull, Request, RequestQueue,
)
from spark_rapids_jni_tpu_torch.table import resolve_device

__all__ = ["Config", "Scheduler", "QueueFull"]

OVERFLOW_TENANT = "_overflow"
COUNTERS = ("requests", "batches", "coalesced", "fallbacks", "cancelled",
            "deadline", "rejected", "tick_errors")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    """Scheduler tuning; defaults come from ``SRJ_TPU_SERVE_*`` env."""

    max_depth: int = dataclasses.field(
        default_factory=lambda: _env_int("SRJ_TPU_SERVE_DEPTH", 256))
    tick_s: float = dataclasses.field(
        default_factory=lambda: _env_float("SRJ_TPU_SERVE_TICK", 0.002))
    max_tenants: int = dataclasses.field(
        default_factory=lambda: _env_int("SRJ_TPU_SERVE_MAX_TENANTS", 64))
    high_water: Optional[int] = dataclasses.field(
        default_factory=lambda: (
            _env_int("SRJ_TPU_SERVE_HIWATER", 0) or None))
    max_batch: Optional[int] = dataclasses.field(
        default_factory=lambda: (
            _env_int("SRJ_TPU_SERVE_MAX_BATCH", 0) or None))
    default_deadline_s: Optional[float] = dataclasses.field(
        default_factory=lambda: (
            _env_float("SRJ_TPU_SERVE_DEADLINE_MS", 0.0) / 1e3 or None))


class Scheduler:
    """Multi-tenant serving scheduler over the shape-bucket grid, on
    ``device`` (default: the CUDA card; ``device="cpu"`` runs the kernels'
    plain versions).

    Use as a context manager or call :meth:`start` / :meth:`close`
    explicitly; :meth:`submit` returns a ``concurrent.futures.Future``
    resolving to the op's result dict.  :meth:`tick` is public so tests
    and single-threaded embeddings can pump the loop deterministically
    without the background thread."""

    def __init__(self, config: Optional[Config] = None, *, device=None):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.queue = RequestQueue(self.config.max_depth,
                                  self.config.high_water)
        self.counters: Dict[str, collections.Counter] = {
            name: collections.Counter() for name in COUNTERS}
        self._tenant_labels: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        self.ticks = 0
        self.served = 0

    def _count(self, name: str, key: str = "", k: int = 1) -> None:
        with self._lock:
            self.counters[name][key] += k

    def total(self, name: str) -> int:
        """Counter ``name`` summed over its keys."""
        with self._lock:
            return sum(self.counters[name].values())

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Scheduler":
        if self._thread is None and not self._closed:
            self._thread = threading.Thread(
                target=self._loop, name="srj-serve-scheduler", daemon=True)
            self._thread.start()
        return self

    def __enter__(self) -> "Scheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admitting, then either serve what is pending (``drain``)
        or fail it with ``QueueFull("closed")``; join the loop thread."""
        if self._closed:
            return
        self._closed = True
        self.queue.close()
        if not drain:
            for reqs in self.queue.drain().values():
                for r in reqs:
                    self._resolve(r.future, exc=QueueFull(
                        "closed", 0, self.config.max_depth))
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        if drain:
            while self.tick():   # bounded (max_batch) drains may need
                pass             # several passes to empty the queue

    # -- submission --------------------------------------------------------

    def _tenant_label(self, tenant: str) -> str:
        with self._lock:
            lbl = self._tenant_labels.get(tenant)
            if lbl is not None:
                return lbl
            if len(self._tenant_labels) >= self.config.max_tenants:
                # at the cardinality cap: do NOT remember the id, or a
                # tenant-id flood would grow this dict without bound
                return OVERFLOW_TENANT
            self._tenant_labels[tenant] = tenant
            return tenant

    def submit(self, tenant: str, op: str, **kwargs
               ) -> "concurrent.futures.Future":
        """Validate and enqueue one query; raises :class:`QueueFull` on
        admission rejection, ``ValueError`` on a malformed payload.
        ``deadline_s`` (popped before op validation) bounds the request's
        total queue and dispatch time; omitted, the
        ``SRJ_TPU_SERVE_DEADLINE_MS`` default applies (0 = unbounded)."""
        deadline_s = kwargs.pop("deadline_s", None)
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s else None)
        opdef = serve_ops.get(op)
        payload, sig, rows, nbytes = opdef.validate(dict(kwargs))
        fut: concurrent.futures.Future = concurrent.futures.Future()
        req = Request(tenant=str(tenant), op=op, sig=sig, payload=payload,
                      future=fut, rows=rows, nbytes=nbytes,
                      deadline=deadline)
        try:
            self.queue.submit(req)
        except QueueFull as e:
            self._count("rejected", e.reason)
            raise
        self._tenant_label(req.tenant)
        self._count("requests", op)
        return fut

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.queue.wait(self.config.tick_s)
            self._tick_guarded()
        self._tick_guarded()     # drain whatever raced the stop flag

    def _tick_guarded(self) -> None:
        # the daemon thread must survive ANY tick bug: an escaped exception
        # here would hang every tenant's pending futures
        try:
            self.tick()
        except Exception:        # noqa: BLE001 (counted, the loop lives on)
            self._count("tick_errors")

    @staticmethod
    def _resolve(fut, result=None, exc=None) -> bool:
        """Resolve ``fut`` if it still can be (not cancelled, not already
        resolved); True when this call resolved it.  One unresolvable
        future must never abort resolution of the rest of a group."""
        if fut.done():
            return False
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
            return True
        except concurrent.futures.InvalidStateError:
            return False

    def tick(self) -> int:
        """Process pending groups now (all of them, or up to
        ``Config.max_batch`` requests); returns requests served."""
        groups = self.queue.drain(self.config.max_batch)
        n = 0
        for (op, sig), reqs in groups.items():
            try:
                n += self._execute_group(op, sig, reqs)
            except Exception as e:   # noqa: BLE001 (fail the group, keep
                # ticking: the other groups' tenants are innocent)
                self._count("tick_errors", op)
                for r in reqs:
                    self._resolve(r.future, exc=e)
                n += len(reqs)
        if groups:
            with self._lock:
                self.ticks += 1
                self.served += n
        return n

    def _execute_group(self, op: str, sig, reqs: List[Request]) -> int:
        opdef = serve_ops.get(op)
        # deadline gate FIRST: an expired request is dropped before its
        # future is even claimed; it never reaches staging and costs the
        # co-batched tenants nothing
        now = time.monotonic()
        fresh: List[Request] = []
        for r in reqs:
            if r.deadline is not None and now >= r.deadline:
                err = _resilience.DeadlineExceeded(
                    op, time.perf_counter() - r.t_submit)
                if self._resolve(r.future, exc=err):
                    self._count("deadline", op)
            else:
                fresh.append(r)
        # claim every future (executor protocol): a request cancelled while
        # queued is dropped here, and the survivors can no longer be
        # cancelled mid-scatter
        live: List[Request] = []
        for r in fresh:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self._count("cancelled", op)
        if not live:
            return len(reqs)
        try:
            outs = self._dispatch(opdef, sig, live)
            for slot, r in enumerate(live):
                self._resolve(r.future, opdef.unbatch(outs, slot, r.payload))
            self._count("batches", op)
            self._count("coalesced", op, len(live))
        except Exception:
            # group poisoned: isolate tenants by retrying each request as
            # its own single-slot batch; only the request whose retry ALSO
            # fails carries an error.  Futures the scatter loop already
            # resolved are skipped, not re-dispatched.
            for r in live:
                if r.future.done():
                    continue
                self._count("fallbacks", op)
                try:
                    outs = self._dispatch(opdef, r.sig, [r])
                    self._resolve(r.future,
                                  opdef.unbatch(outs, 0, r.payload))
                except Exception as e:   # noqa: BLE001 (the future has it)
                    self._resolve(r.future, exc=e)
        return len(reqs)

    def _dispatch(self, opdef, sig, reqs: List[Request]) -> List:
        """ONE staged transfer, ONE kernel call, ONE fetch for the whole
        group (the continuous-batching hot path).  A resource failure
        (CUDA out of memory) degrades through :meth:`_split_dispatch`."""
        kb = shapes.bucket_rows(len(reqs))
        try:
            bufs = opdef.batch([r.payload for r in reqs], sig, kb)
            staged = staging.stage_arrays(bufs, self.device)
            outs = opdef.kernel(sig, kb)(*staged)
            return staging.fetch_arrays(list(outs))
        except Exception as e:   # noqa: BLE001 (classified below)
            if (_resilience.classify(e) == _resilience.RESOURCE
                    and len(reqs) >= 2):
                return self._split_dispatch(opdef, sig, reqs)
            raise

    def _split_dispatch(self, opdef, sig, reqs: List[Request]) -> List:
        """Request-axis OOM degradation: halve the group and recurse, then
        merge the slot-major outputs so slot ``i`` still belongs to request
        ``i``.  Halves re-bucket onto the same pow-2 slot grid, and per-slot
        results are byte-identical to the unsplit run because slot ``i``
        never reads slot ``j``."""
        mid = len(reqs) // 2
        n = len(reqs)
        lo = self._dispatch(opdef, sig, reqs[:mid])
        hi = self._dispatch(opdef, sig, reqs[mid:])
        return [np.concatenate([a[:mid], b[:n - mid]], axis=0)
                for a, b in zip(lo, hi)]

    # -- health ------------------------------------------------------------

    def healthz(self) -> dict:
        """Queue depth and shed state, for a caller routing load."""
        return {
            "queue_depth": self.queue.depth,
            "shedding": self.queue.shedding,
            "closed": self.queue.closed,
            "max_depth": self.config.max_depth,
            "high_water": self.queue.high_water,
            "tenants": len(self._tenant_labels),
            "ticks": self.ticks,
            "served": self.served,
        }
