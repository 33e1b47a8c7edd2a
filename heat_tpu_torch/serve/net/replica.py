"""Replica process: restore, warm, listen, drain on SIGTERM.

``python -m heat_tpu_torch.serve.net.replica --checkpoint CKPT
[--device cuda|cpu] [--host H] [--port P]`` is the unit
:class:`~.pool.ReplicaPool` spawns. Counterpart of
``heat_tpu/serve/net/replica.py``; the JAX package's ``--mesh N`` has no
counterpart: the replica runs on the card unless ``--device cpu`` is
given. Its life:

1. on the card, find the kernel libraries built in the checkout's kernel
   build directory, building only what is missing
   (:func:`heat_tpu_torch.core.program_cache.enable_persistent_cache`), so
   a second replica compiles nothing;
2. :meth:`heat_tpu_torch.serve.Server.restore` the serve checkpoint (of
   either package) onto the device: a replica is born from a checkpoint,
   never refit;
3. ``warmup()`` the whole ladder (a CUDA graph captured per bucket);
4. start the :class:`~.transport.HttpFront` (which arms the steady-state
   CompileWatcher that ``/stats`` reports) and print ONE ready line on
   standard output::

       {"ready": true, "port": <bound>, "pid": ..., "warmup": {...}, ...}

5. on SIGTERM or SIGINT: shed new requests 503/``draining``, finish the
   queued and in-flight batches, flush telemetry, print the exit record
   and exit 0.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.serve.net.replica",
        description="One serving replica: restore a serve checkpoint, warm the ladder, "
                    "serve HTTP until SIGTERM.")
    p.add_argument("--checkpoint", required=True,
                   help="serve checkpoint directory (Server.save of either package)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the endpoints run (default: the card)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="listen port (default HEAT_TPU_SERVE_NET_PORT; 0 binds an ephemeral "
                        "port, printed in the ready line)")
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="seconds a request's future may take before HTTP 504")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds the SIGTERM drain waits for queued and in-flight work")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    t0 = time.perf_counter()
    import heat_tpu_torch as ht
    from heat_tpu_torch import _build, telemetry
    from heat_tpu_torch.core import program_cache
    from heat_tpu_torch.serve import Server, tracing

    from .transport import HttpFront

    if args.device == "cpu":
        ht.use_device("cpu")
        device = "cpu"
    else:
        import torch

        if not torch.cuda.is_available():
            print("replica: no CUDA device is available (pass --device cpu to serve on the CPU)",
                  file=sys.stderr, flush=True)
            return 2
        program_cache.enable_persistent_cache()
        device = "cuda"
    t_restore = time.perf_counter()
    server = Server.restore(args.checkpoint, device=device)
    restore_s = time.perf_counter() - t_restore
    warm = server.warmup()
    front = HttpFront(server, host=args.host, port=args.port,
                      request_timeout=args.request_timeout)
    front.warmup_report = warm
    front.kernel_builds = _build.compiled_count()
    front.start()

    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 - the signal contract
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(json.dumps({
        "ready": True,
        "url": front.url,
        "port": front.port,
        "pid": os.getpid(),
        "device": device,
        "endpoints": sorted(server.endpoints()),
        "warmup": warm,
        "restore_s": restore_s,
        "start_s": time.perf_counter() - t0,
        "kernel_builds": front.kernel_builds,
        "tracing": tracing.active(),
    }), flush=True)

    stop.wait()
    drained = front.drain(args.drain_timeout)
    telemetry.flush("sigterm_drain")
    print(json.dumps({"exit": True, "drained": drained, "pid": os.getpid()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
