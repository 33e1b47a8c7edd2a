"""Spawned worlds of gloo ranks for the heat_tpu_torch scale-out tests.

``spawn(tmp, world, script, env)`` runs ``script`` in ``world`` processes
(one gloo rank each, on the CPU): the script defines ``run(ht, rank,
world) -> dict`` of numpy arrays (the package imported after the process
group starts), and each rank's dict comes back, in rank order. ``env``
adds environment variables (knobs) to every rank.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_HEAD = """
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
import heat_tpu_torch as ht
ht.use_device("cpu")
torch.manual_seed(0)
"""

_TAIL = """
res = run(ht, rank, world)
np.savez(f"{out}/rank{rank}.npz", **{k: np.asarray(v) for k, v in res.items()})
dist.barrier()
dist.destroy_process_group()
"""


def spawn(tmp, world: int, script: str, env=None, timeout: float = 300.0):
    """Each rank's results of ``script``'s ``run`` on ``world`` gloo ranks."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    full_env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                    **{k: str(v) for k, v in (env or {}).items()})
    code = _HEAD + script + _TAIL
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port),
                               str(tmp)], cwd=REPO, env=full_env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-4000:] for log in logs)
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=False)) for r in range(world)]
