"""The horizontally scaled serving tier, on the stdlib alone.

Counterpart of ``heat_tpu/serve/net``:

* :mod:`.wire`: the JSON and base64-``.npy`` wire schema, byte for byte
  the JAX package's (bitwise round trip, so exact-mode answers survive
  the hop, and either package's router reaches either package's replica);
* :mod:`.transport`: :class:`HttpFront`, ``POST /v1/<endpoint>`` onto
  ``Server.submit()``, with ``/healthz``, ``/stats`` (the remote zero-build
  oracle), ``/metrics`` and ``/trace``;
* :mod:`.replica`: the replica process (``python -m
  heat_tpu_torch.serve.net.replica --checkpoint CKPT [--device cuda|cpu]``);
* :mod:`.pool`: :class:`ReplicaPool`, spawning, draining and killing
  replicas over one checkpoint;
* :mod:`.router`: :class:`Router`, least-loaded dispatch, sibling retries,
  health eviction and re-add, priority classes (weighted-fair admission)
  and hedged retries;
* :mod:`.controller`: :class:`AutoscaleController`, the SLO-driven
  autoscaler over a pool and its router.
"""

from __future__ import annotations

from .controller import AutoscaleController
from .events import EVENT_COUNTER
from .pool import ReplicaHandle, ReplicaPool
from .router import ReplicaDownError, Router
from .transport import HttpFront
from .wire import WireError
from . import controller, events, pool, replica, router, transport, wire  # noqa: F401

__all__ = [
    "AutoscaleController",
    "EVENT_COUNTER",
    "HttpFront",
    "ReplicaDownError",
    "ReplicaHandle",
    "ReplicaPool",
    "Router",
    "WireError",
]
