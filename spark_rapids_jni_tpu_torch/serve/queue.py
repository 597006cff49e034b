"""Bounded multi-tenant request queue with admission control.

A copy of ``spark_rapids_jni_tpu.serve.queue`` (pure Python; the port keeps
its own copy and imports nothing of the JAX package).  The serving layer's
front door: :class:`RequestQueue` accepts per-tenant submissions and hands
the scheduler whole *coalescing groups*: every pending request keyed by
``(op, static signature)``, so one drain yields exactly the batches the
scheduler can fuse into one kernel launch each (the signature carries the
shape-bucket dims from :mod:`runtime.shapes`, so same-bucket requests always
land in the same group).

Admission control is explicit, never silent: :meth:`RequestQueue.submit`
raises :class:`QueueFull` when the queue is at capacity (``reason
="full"``), when backpressure shedding is active (``reason="shedding"``),
or after close (``reason="closed"``).  Shedding has hysteresis: it trips
when depth reaches the high-water mark and clears only when a drain takes
depth back to the low-water mark, so a queue hovering at the boundary flaps
once, not per request.  An unbounded drain empties the queue and so always
clears shedding; the low-water gate bites when the scheduler drains
boundedly (``Config.max_batch`` / ``SRJ_TPU_SERVE_MAX_BATCH``).  The
scheduler's ``healthz()`` reports both depth and the shed flag.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["QueueFull", "Request", "RequestQueue"]


class QueueFull(RuntimeError):
    """Admission rejection: the request was NOT enqueued.

    ``reason`` is one of ``"full"`` (hard depth cap), ``"shedding"``
    (backpressure high-water tripped and has not yet drained to the
    low-water mark), or ``"closed"`` (scheduler shutting down).  Callers
    retry with backoff or route elsewhere; nothing blocks.
    """

    def __init__(self, reason: str, depth: int, limit: int):
        super().__init__(
            f"serve queue rejected request ({reason}): "
            f"depth {depth}, limit {limit}")
        self.reason = reason
        self.depth = depth
        self.limit = limit


@dataclasses.dataclass
class Request:
    """One pending query: validated payload plus accounting metadata.

    ``sig`` is the op's static coalescing signature (shape-bucket dims);
    requests sharing ``(op, sig)`` batch into one dispatch.  ``rows`` /
    ``nbytes`` describe its size; ``t_submit`` anchors its queue
    latency.  ``trace``/``trace_parent`` are the request's trace context
    and its submitter's span, which the port leaves ``None`` until its
    observability layer exists (``ROADMAP.md`` queue 1, item 13).
    ``deadline`` is an absolute ``time.monotonic()`` instant (None =
    unbounded): the scheduler drops an expired request *before* staging
    (``DeadlineExceeded``, never dispatched)."""

    tenant: str
    op: str
    sig: Tuple
    payload: Dict[str, Any]
    future: Any
    rows: int
    nbytes: int
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    trace: Any = None
    trace_parent: Optional[str] = None
    deadline: Optional[float] = None


class RequestQueue:
    """Bounded FIFO of :class:`Request` with shed-state hysteresis.

    Thread-safe; the condition variable wakes the scheduler loop on the
    first submission after idle so a lone request is not stuck waiting a
    full tick interval."""

    def __init__(self, max_depth: int, high_water: Optional[int] = None,
                 low_water: Optional[int] = None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = max_depth
        self.high_water = high_water if high_water is not None \
            else max(1, (3 * max_depth) // 4)
        self.high_water = min(self.high_water, max_depth)
        self.low_water = low_water if low_water is not None \
            else self.high_water // 2
        self._cond = threading.Condition()
        self._pending: List[Request] = []
        self._shedding = False
        self._closed = False

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue or raise :class:`QueueFull`; never blocks."""
        with self._cond:
            depth = len(self._pending)
            if self._closed:
                raise QueueFull("closed", depth, self.max_depth)
            if depth >= self.max_depth:
                self._shedding = True
                raise QueueFull("full", depth, self.max_depth)
            if self._shedding:
                raise QueueFull("shedding", depth, self.high_water)
            self._pending.append(req)
            if len(self._pending) >= self.high_water:
                self._shedding = True
            self._cond.notify_all()

    # -- scheduler side ----------------------------------------------------

    def drain(self, limit: Optional[int] = None
              ) -> Dict[Tuple[str, Tuple], List[Request]]:
        """Take up to ``limit`` pending requests (all of them when
        ``limit`` is None or <= 0), FIFO, grouped by coalescing key.

        Clears shedding when the post-drain depth is at or under the
        low-water mark — the hysteresis release edge.  A full drain
        therefore always clears shedding (depth falls to 0); low-water
        only gates bounded drains (scheduler ``max_batch``)."""
        with self._cond:
            if limit is not None and 0 < limit < len(self._pending):
                taken = self._pending[:limit]
                self._pending = self._pending[limit:]
            else:
                taken, self._pending = self._pending, []
            if self._shedding and len(self._pending) <= self.low_water:
                self._shedding = False
        groups: Dict[Tuple[str, Tuple], List[Request]] = {}
        for r in taken:
            groups.setdefault((r.op, r.sig), []).append(r)
        return groups

    def wait(self, timeout: float) -> bool:
        """Block up to ``timeout`` seconds for pending work; True if any."""
        with self._cond:
            if self._pending:
                return True
            self._cond.wait(timeout)
            return bool(self._pending)

    def close(self) -> None:
        """Stop admitting; pending requests stay drainable."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- introspection -----------------------------------------------------

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    @property
    def shedding(self) -> bool:
        with self._cond:
            return self._shedding

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
