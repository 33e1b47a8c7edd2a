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
  health eviction and re-add.

Not ported yet (ROADMAP §1 item 14): ``controller`` (the autoscaler), and
the router's priority classes and hedged retries that go with it.
"""

from __future__ import annotations

from .events import EVENT_COUNTER
from .pool import ReplicaHandle, ReplicaPool
from .router import ReplicaDownError, Router
from .transport import HttpFront
from .wire import WireError
from . import events, pool, replica, router, transport, wire  # noqa: F401

__all__ = [
    "EVENT_COUNTER",
    "HttpFront",
    "ReplicaDownError",
    "ReplicaHandle",
    "ReplicaPool",
    "Router",
    "WireError",
]
