#!/usr/bin/env python3
"""How far the port's normal draws are from the JAX package's, on the CPU.

Draws 2^20 standard normals from one key through ``jax.random.normal`` and
through ``heat_tpu_torch``'s plain threefry draw (``core/_threefry.py``),
in float32 and float64, and prints one JSON line per type: the largest
difference in ulp and the share of draws that are bit-identical. XLA's
CPU code changes with its optimisation level (its float32 ``log1p``, its
fused multiply-adds), so the level is an argument:

    python3 tools/measure_normal_ulp.py            # XLA's default level
    python3 tools/measure_normal_ulp.py 0          # the test suite's level

Run from the repository root; it needs jax and numpy beside torch.
"""

import json
import os
import sys

if len(sys.argv) > 1:
    os.environ["XLA_FLAGS"] = f"--xla_backend_optimization_level={int(sys.argv[1])}"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from heat_tpu_torch.core import _threefry as tf  # noqa: E402

jax.config.update("jax_enable_x64", True)
N = 1 << 20
key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
k = tf.fold_in(tf.prng_key(7), 3)
for jt, tt, it in ((jnp.float32, torch.float32, np.int32), (jnp.float64, torch.float64, np.int64)):
    ref = np.asarray(jax.random.normal(key, (N,), jt)).view(it).astype(np.int64)
    got = tf.normal(k, tf.Slice.whole((N,)), tt).numpy().view(it).astype(np.int64)
    ulp = np.abs(ref - got)
    print(json.dumps({"dtype": str(tt).split(".")[-1], "draws": N,
                      "xla_opt_level": sys.argv[1] if len(sys.argv) > 1 else "default",
                      "max_ulp": int(ulp.max()), "bit_identical_share": float((ulp == 0).mean())}))
