"""Replica pool: spawn, warm, scale, drain and kill replica processes.

Counterpart of ``heat_tpu/serve/net/pool.py``. :class:`ReplicaPool` turns
one serve checkpoint into N serving processes, each
``python -m heat_tpu_torch.serve.net.replica`` on the same checkpoint and
on the pool's ``device`` (the card unless ``"cpu"``). On the card the
replicas of one checkout share its kernel build directory, so a second
replica finds every kernel built. The pool:

* **spawns** replicas as subprocesses, reads each one's ready line (bound
  port, warm-up report) and keeps its standard error in a log file;
* **scales up** (:meth:`spawn`): a new replica, ready for
  ``Router.add_target``;
* **removes gracefully** (:meth:`remove`): one SIGTERM; the replica sheds
  new work 503-style, finishes its backlog, flushes telemetry and exits
  0, and the pool returns the exit code;
* **kills** (:meth:`kill`): SIGKILL, for chaos tests;
* **restores**: a replica is born from a checkpoint, so crash recovery is
  :meth:`spawn` again.

Per-replica admission budgets (queue bound, ladder top, memory budget)
travel through the ``env`` mapping.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ... import _knobs as knobs
from .events import emit as _emit

# the directory that holds the heat_tpu_torch package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

__all__ = ["ReplicaPool", "ReplicaHandle"]


class ReplicaHandle:
    """One spawned replica process: subprocess handle, bound address,
    ready-line payload, and the stderr log path."""

    def __init__(self, index: int, proc: subprocess.Popen, log_path: str):
        self.index = index
        self.proc = proc
        self.log_path = log_path
        self.t_spawn = time.perf_counter()
        self.ready_s: Optional[float] = None  # spawn to ready line, seconds
        self.port: Optional[int] = None
        self.url: Optional[str] = None
        self.ready: Optional[dict] = None
        self.state = "spawning"  # spawning | up | removed | killed | dead
        self._lines: List[str] = []
        self._reader = threading.Thread(
            target=self._read_stdout, daemon=True,
            name=f"heat_tpu_torch.serve.net.pool-reader-{index}",
        )
        self._reader.start()

    def _read_stdout(self) -> None:
        for line in self.proc.stdout:
            self._lines.append(line)
        try:
            self.proc.stdout.close()
        except Exception:
            pass

    def wait_ready(self, timeout: float) -> dict:
        """Block until the replica's ready line (or death/timeout)."""
        deadline = time.monotonic() + timeout
        seen = 0
        while time.monotonic() < deadline:
            while seen < len(self._lines):
                line = self._lines[seen].strip()
                seen += 1
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if obj.get("ready"):
                    self.ready = obj
                    self.ready_s = time.perf_counter() - self.t_spawn
                    self.port = int(obj["port"])
                    self.url = str(obj["url"])
                    self.state = "up"
                    return obj
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.index} exited rc={self.proc.returncode} "
                    f"before its ready line; stderr tail:\n"
                    f"{self.log_tail()}"
                )
            time.sleep(0.02)
        raise TimeoutError(
            f"replica {self.index} produced no ready line within {timeout}s; "
            f"stderr tail:\n{self.log_tail()}"
        )

    def exit_lines(self) -> List[dict]:
        """Every JSON line the replica printed after ready (the graceful
        exit record lands here)."""
        out = []
        for line in list(self._lines):
            try:
                obj = json.loads(line.strip())
            except (json.JSONDecodeError, AttributeError):
                continue
            if not obj.get("ready"):
                out.append(obj)
        return out

    def log_tail(self, max_bytes: int = 4000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return "<no log>"

    def alive(self) -> bool:
        return self.proc.poll() is None


class ReplicaPool:
    """Spawn + manage ``replicas`` serving processes over one endpoint
    checkpoint (module docstring has the lifecycle)."""

    def __init__(
        self,
        checkpoint: str,
        replicas: Optional[int] = None,
        *,
        device: str = "cuda",
        host: str = "127.0.0.1",
        env: Optional[Dict[str, str]] = None,
        python: Optional[str] = None,
        ready_timeout: float = 240.0,
        log_dir: Optional[str] = None,
        replica_args: Optional[List[str]] = None,
    ):
        self.checkpoint = str(checkpoint)
        self.n = int(
            replicas if replicas is not None
            else knobs.get("HEAT_TPU_SERVE_NET_REPLICAS")
        )
        if self.n < 1:
            raise ValueError(f"need at least one replica, got {self.n}")
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.device = device
        self.host = host
        self.env_overrides = dict(env or {})
        self.python = python or sys.executable
        self.ready_timeout = float(ready_timeout)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="heat_tpu_pool_")
        os.makedirs(self.log_dir, exist_ok=True)
        self.replica_args = list(replica_args or [])
        self.replicas: List[ReplicaHandle] = []
        self.failed: List[ReplicaHandle] = []   # warmup-dead, reaped
        self._next_index = 0
        self._sleep = time.sleep                # injectable (spawn-retry backoff)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaPool":
        """Spawn all replicas CONCURRENTLY, then wait for every ready
        line (imports and warm-ups overlap across processes). A replica
        that dies before ready is reaped (never left a zombie target)
        before the error propagates."""
        handles = [self._spawn_one() for _ in range(self.n)]
        first_error = None
        for h in handles:
            try:
                h.wait_ready(self.ready_timeout)
            except Exception as e:  # noqa: BLE001 — reap, then re-raise
                self._reap(h, why=repr(e))
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return self

    def spawn(
        self,
        checkpoint: Optional[str] = None,
        *,
        retries: Optional[int] = None,
        backoff_s: float = 0.5,
    ) -> ReplicaHandle:
        """Add ONE replica (scale-up / re-add after a kill); blocks
        until its ready line. ``checkpoint`` births the replica from
        another checkpoint than the pool default, the rolling-update
        primitive: a replica process serves one checkpoint version for
        its whole life, so replacing replicas one by one rolls a new
        version through the pool.

        Failure path: a replica that dies (or hangs) during
        warmup is **reaped** — killed, marked dead, dropped from the
        live set, ``spawn_fail`` evented — and the spawn retried with
        exponential backoff up to ``retries`` extra attempts (default
        ``HEAT_TPU_AUTOSCALE_SPAWN_RETRIES``). It is never left as a
        zombie target a router keeps scoring."""
        attempts = 1 + int(
            retries if retries is not None
            else knobs.get("HEAT_TPU_AUTOSCALE_SPAWN_RETRIES")
        )
        delay = float(backoff_s)
        last: Optional[Exception] = None
        for i in range(max(1, attempts)):
            h = self._spawn_one(checkpoint=checkpoint)
            try:
                h.wait_ready(self.ready_timeout)
                return h
            except Exception as e:  # noqa: BLE001 — reap + retry
                last = e
                self._reap(h, why=repr(e))
                if i + 1 < attempts:
                    self._sleep(delay)
                    delay *= 2
        raise RuntimeError(
            f"replica spawn failed {attempts} time(s) "
            f"(reaped each attempt; last log at "
            f"{self.failed[-1].log_path if self.failed else '<none>'})"
        ) from last

    def _reap(self, h: ReplicaHandle, why: str = "") -> None:
        """Remove a warmup-dead replica from the live set: kill the
        process if anything is left of it, mark the handle dead, move
        it to ``self.failed`` (log kept for post-mortems), and emit
        ``spawn_fail``. After this the handle can never appear in
        :meth:`urls` — no zombie targets."""
        try:
            if h.alive():
                h.proc.kill()
                h.proc.wait(10.0)
        except Exception:
            pass
        h.state = "dead"
        try:
            self.replicas.remove(h)
        except ValueError:
            pass
        self.failed.append(h)
        _emit("pool", "spawn_fail", replica=h.index,
              rc=h.proc.returncode, why=why[:200])

    def set_checkpoint(self, checkpoint: str) -> None:
        """Re-point the pool default checkpoint (future spawns,
        including crash-recovery respawns, pick up the new version)."""
        self.checkpoint = str(checkpoint)

    def _spawn_one(self, checkpoint: Optional[str] = None) -> ReplicaHandle:
        index = self._next_index
        self._next_index += 1
        cmd = [
            self.python, "-m", "heat_tpu_torch.serve.net.replica",
            "--checkpoint", str(checkpoint or self.checkpoint),
            "--device", self.device, "--host", self.host, "--port", "0",
        ]
        cmd += self.replica_args
        env = dict(os.environ)
        # the replica imports this very package, whatever its cwd
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p
        )
        env.update(self.env_overrides)
        log_path = os.path.join(self.log_dir, f"replica_{index}.log")
        logf = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=logf, env=env,
                text=True,
            )
        finally:
            logf.close()  # the child holds its own descriptor
        h = ReplicaHandle(index, proc, log_path)
        self.replicas.append(h)
        _emit("pool", "spawn", replica=index, pid=proc.pid)
        return h

    def urls(self) -> List[str]:
        """Base URLs of every live replica (Router's target list)."""
        return [
            h.url for h in self.replicas
            if h.state == "up" and h.url and h.alive()
        ]

    def handle(self, index: int) -> ReplicaHandle:
        for h in self.replicas:
            if h.index == index:
                return h
        raise KeyError(f"no replica with index {index}")

    # -- management ----------------------------------------------------------

    def stats(self, index: int, timeout: float = 5.0) -> dict:
        """``GET /stats`` from one replica."""
        return self._get_json(index, "/stats", timeout)

    def metrics(self, index: int, timeout: float = 5.0) -> dict:
        """``GET /metrics`` from one replica: the cumulative mergeable
        scrape (raw latency-histogram buckets, version map, tracing
        counters)."""
        return self._get_json(index, "/metrics", timeout)

    def scrape_metrics(self, timeout: float = 5.0) -> Dict[str, dict]:
        """``{url: metrics payload}`` across every live replica (None for a
        replica that did not answer)."""
        out: Dict[str, dict] = {}
        for h in self.replicas:
            if h.state == "up" and h.url and h.alive():
                try:
                    out[h.url] = self.metrics(h.index, timeout)
                except Exception:
                    out[h.url] = None
        return out

    def _get_json(self, index: int, path: str, timeout: float) -> dict:
        import http.client

        h = self.handle(index)
        conn = http.client.HTTPConnection(self.host, h.port, timeout=timeout)
        try:
            conn.request("GET", path)
            return json.loads(conn.getresponse().read().decode())
        finally:
            conn.close()

    def kill(self, index: int) -> None:
        """SIGKILL — the chaos primitive. No drain, no flush: only this
        replica's in-flight requests are lost (router semantics)."""
        h = self.handle(index)
        if h.alive():
            h.proc.kill()
            h.proc.wait(10.0)
        h.state = "killed"
        _emit("pool", "kill", replica=index)

    def remove(self, index: int, timeout: float = 60.0) -> int:
        """Drain-then-kill removal: SIGTERM → the replica sheds new work
        (router retries siblings), finishes its backlog, flushes
        telemetry, exits. Returns the exit code (0 = clean drain;
        asserted by the rolling update) — a replica that ignores the deadline
        is hard-killed and reports its real rc."""
        h = self.handle(index)
        if h.alive():
            h.proc.send_signal(signal.SIGTERM)
            try:
                h.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(10.0)
        h.state = "removed"
        rc = int(h.proc.returncode)
        _emit("pool", "remove", replica=index, rc=rc)
        return rc

    def close(self, timeout: float = 30.0) -> None:
        """Tear the pool down: graceful SIGTERM sweep, hard kill for
        stragglers. Idempotent."""
        for h in self.replicas:
            if h.alive():
                try:
                    h.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for h in self.replicas:
            if h.proc.poll() is None:
                try:
                    h.proc.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait(10.0)
            if h.state in ("spawning", "up"):
                h.state = "dead"

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
