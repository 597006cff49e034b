"""The failure taxonomy and the admission backoff of the serving runtime.

The PyTorch counterpart of what the serve scheduler and client call of
``spark_rapids_jni_tpu.runtime.resilience``: :class:`DeadlineExceeded`,
:func:`classify` (the four classes; a CUDA out-of-memory error is
``resource``, which the scheduler answers by halving a group on its request
axis), and :func:`default_policy` with :func:`backoff_s` (decorrelated
jitter) for the client's admission retry.  ``run`` with its transient
retries, the circuit breakers and ``allow_impl`` wait for a later slice
(``ROADMAP.md`` queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
import os
import random

import torch

__all__ = ["TRANSIENT", "RESOURCE", "DETERMINISTIC", "FATAL",
           "DeadlineExceeded", "classify", "Policy", "default_policy",
           "backoff_s"]

TRANSIENT = "transient"
RESOURCE = "resource"
DETERMINISTIC = "deterministic"
FATAL = "fatal"

_RESOURCE_TOKENS = ("RESOURCE_EXHAUSTED", "OUT OF MEMORY", "OOM",
                    "ALLOCATION FAILURE", "FAILED TO ALLOCATE")
_TRANSIENT_TOKENS = ("ABORTED", "UNAVAILABLE", "DEVICE BUSY",
                     "CONNECTION RESET", "SOCKET CLOSED",
                     "TRY AGAIN", "TEMPORARILY")
_FATAL_TOKENS = ("DEVICE UNUSABLE", "DEVICE DEAD", "DEVICE HALTED",
                 "DATA_LOSS")


class DeadlineExceeded(TimeoutError):
    """The caller's deadline expired before (or while) the op ran.  The
    work was dropped or abandoned, never half-applied: expiry is checked
    before any dispatch."""

    def __init__(self, op: str, waited_s: float = 0.0):
        super().__init__(
            f"{op}: deadline exceeded after {waited_s * 1e3:.1f} ms")
        self.op = op
        self.waited_s = waited_s


def classify(exc: BaseException) -> str:
    """Fold one exception into the four classes.  Unknown errors classify
    *deterministic*, the safe default: no retry, no split."""
    if isinstance(exc, DeadlineExceeded):
        return DETERMINISTIC
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return RESOURCE
    msg = str(exc).upper()
    if any(t in msg for t in _FATAL_TOKENS):
        return FATAL
    if any(t in msg for t in _RESOURCE_TOKENS):
        return RESOURCE
    if any(t in msg for t in _TRANSIENT_TOKENS):
        return TRANSIENT
    return DETERMINISTIC


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclasses.dataclass
class Policy:
    """Backoff bounds; defaults from the JAX package's variables."""

    base_s: float = dataclasses.field(
        default_factory=lambda: _env_float("SRJ_TPU_RETRY_BASE_S", 0.05))
    cap_s: float = dataclasses.field(
        default_factory=lambda: _env_float("SRJ_TPU_RETRY_CAP_S", 2.0))


def default_policy() -> Policy:
    return Policy()


_RNG = random.Random()


def backoff_s(prev: float, policy: Policy) -> float:
    """Decorrelated jitter: uniform over [base, 3 * prev], capped, so that
    the sleeps of concurrent clients drift apart while still growing
    geometrically in expectation."""
    hi = max(policy.base_s, 3.0 * prev)
    return min(policy.cap_s, _RNG.uniform(policy.base_s, hi))
