"""Multi-tenant serving runtime: continuous batching over the shape-bucket
grid, on the CUDA card.

The PyTorch counterpart of ``spark_rapids_jni_tpu.serve``.  Per-tenant
submissions flow through a bounded queue; a scheduler tick coalesces every
same-shape-bucket group into ONE padded mega-batch, staged host -> device
as one blob (:mod:`runtime.staging`), served by one kernel launch and
fetched back in one transfer, then hands each request its slice.  The
ops are ``agg`` (group-by-sum) and ``join`` (unique-key equi-join), over
the query operators of ``models.pipeline``, and ``rows`` and ``unrows``
(JCUDF row conversion of all-valid INT32 columns, through the word-plane
pack and unpack kernels).

Quick start::

    from spark_rapids_jni_tpu_torch import serve

    with serve.Scheduler() as sched:             # device="cpu" in tests
        c = serve.Client(sched, tenant="analytics")
        fut = c.to_rows([np.arange(5, dtype=np.int32)])
        out = fut.result(timeout=5)              # {'rows': ..., ...}

Admission control raises :class:`QueueFull` instead of blocking;
``Scheduler.healthz()`` reports queue depth and shed state.  The fleet,
router, replica and chaos layers and the ``__main__`` demo wait for later
slices (``ROADMAP.md`` queue 1, item 14).
"""

from spark_rapids_jni_tpu_torch.serve.client import Client  # noqa: F401
from spark_rapids_jni_tpu_torch.serve.queue import QueueFull  # noqa: F401
from spark_rapids_jni_tpu_torch.serve.scheduler import (  # noqa: F401
    Config, Scheduler,
)
from spark_rapids_jni_tpu_torch.serve import ops  # noqa: F401

__all__ = ["Client", "Config", "QueueFull", "Scheduler", "ops"]
