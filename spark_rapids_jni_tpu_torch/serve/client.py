"""Per-tenant client facade over :class:`serve.Scheduler`.

The PyTorch counterpart of ``spark_rapids_jni_tpu.serve.client``: each method
validates through the op registry and returns a
``concurrent.futures.Future`` resolving to the op's result dict (call
``.result(timeout)`` to block).  One client per tenant; clients are cheap
and thread-safe (all state lives in the scheduler).  ``traced`` waits for
the observability layer (``ROADMAP.md`` queue 1, item 13).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from spark_rapids_jni_tpu_torch.runtime import resilience as _resilience
from spark_rapids_jni_tpu_torch.serve.queue import QueueFull

__all__ = ["Client"]


class Client:
    def __init__(self, scheduler, tenant: str):
        self._sched = scheduler
        self.tenant = str(tenant)

    def _submit(self, op: str, deadline_s: Optional[float], kwargs: dict):
        """Submit with admission retry: a ``QueueFull(reason="full")`` is a
        momentary condition (one tick of drain frees a slot), so with a
        deadline in hand it retries under decorrelated-jitter backoff until
        admitted or the deadline expires, never sleeping past ``deadline_s``
        and passing the scheduler only the remaining budget, so that the
        queued request still expires at the caller's original instant.  On
        expiry raises :class:`resilience.DeadlineExceeded`.  Shedding and
        closed rejections re-raise at once (those clear on the queue's
        terms, not the caller's), as does ``full`` with no deadline."""
        if deadline_s is None:
            return self._sched.submit(self.tenant, op, **kwargs)
        deadline = time.monotonic() + float(deadline_s)
        policy = _resilience.default_policy()
        prev_sleep = policy.base_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise _resilience.DeadlineExceeded(
                    f"serve.{op}", float(deadline_s))
            try:
                return self._sched.submit(self.tenant, op,
                                          deadline_s=left, **kwargs)
            except QueueFull as e:
                if e.reason != "full":
                    raise
                sleep = min(_resilience.backoff_s(prev_sleep, policy),
                            max(0.0, deadline - time.monotonic()))
                if sleep <= 0:
                    raise _resilience.DeadlineExceeded(
                        f"serve.{op}", float(deadline_s))
                time.sleep(sleep)
                prev_sleep = max(sleep, policy.base_s)

    def aggregate(self, keys, values, max_groups: Optional[int] = None,
                  deadline_s: Optional[float] = None):
        """Group-by-sum of int32 keys and values; resolves to
        ``{group_keys, sums, have, num_groups}`` (arrays of ``max_groups``,
        default ``serve.ops.DEFAULT_MAX_GROUPS``).

        ``deadline_s`` (here and on every method below) bounds the
        request's total queue and dispatch time: past it the scheduler
        drops the request before staging and its future carries
        :class:`runtime.resilience.DeadlineExceeded`.  It also bounds
        admission: a ``QueueFull(reason="full")`` rejection retries with
        backoff until the deadline (see :meth:`_submit`)."""
        kw = {} if max_groups is None else {"max_groups": max_groups}
        kw.update(keys=keys, values=values)
        return self._submit("agg", deadline_s, kw)

    def join(self, build_keys, build_payload, probe_keys,
             deadline_s: Optional[float] = None):
        """Unique-key equi-join; resolves to ``{payload, matched}`` aligned
        with ``probe_keys`` (unmatched payload slots are 0)."""
        return self._submit("join", deadline_s, dict(
            build_keys=build_keys, build_payload=build_payload,
            probe_keys=probe_keys))

    def to_rows(self, columns: Sequence,
                deadline_s: Optional[float] = None):
        """JCUDF fixed-width row conversion of all-valid int32 columns;
        resolves to ``{rows, row_size, num_rows}`` (flat uint8)."""
        return self._submit("rows", deadline_s, dict(columns=columns))

    def from_rows(self, rows, ncols: int,
                  deadline_s: Optional[float] = None):
        """JCUDF row decode back to ``ncols`` all-valid int32 columns (the
        inverse of :meth:`to_rows`); resolves to ``{columns, num_rows}``.
        ``rows``: flat uint8 blob or ``[n, row_size]``."""
        return self._submit("unrows", deadline_s,
                            dict(rows=rows, ncols=ncols))
