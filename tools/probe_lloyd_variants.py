"""Where the Lloyd kernel's time goes: variants of lloyd_tc with parts removed.

Run from the root of the repository, on a machine with a CUDA card:

    python3 tools/probe_lloyd_variants.py

It writes variants of heat_tpu_torch/csrc/lloyd.cu into build/probe/ (the
kernel as it is; at one block an SM; without the sums; without the score
products), builds each with the package's nvcc
flags, runs each at the KMeans path's pass (2,000,000 x 64, k = 64) and at
the gate's corner (20,011 x 512, k = 1024), and prints, per variant,
whether its counts equal the plain version's and its time (CUDA events,
two rounds of 20 launches), beside torch's sum of X as a yardstick for
reading X. The variants without sums or products give wrong results by
design; they show what the rest costs. The results also go to
build/probe/probe.json.
"""
import ctypes, json, os, subprocess, sys
from pathlib import Path
sys.path.insert(0, os.getcwd())
import torch
from heat_tpu_torch import _build
from heat_tpu_torch.cluster.cuda_lloyd import lloyd_update_plain

src = (_build.CSRC / "lloyd.cu").read_text()
out = Path("build/probe"); out.mkdir(parents=True, exist_ok=True)
PRODUCTS = """            wgmma_fence();
            panel_products(s, hi, lo, smem_u32(chi + u * TC_UNIT), smem_u32(clo + u * TC_UNIT),
                           pn == 0);
            wgmma_commit();
            wgmma_wait<0>();"""
ACCUM = "      if (accumulates) {"
ONE_BLOCK = "constexpr int TC_MIN_BLOCKS = 2;"
for pat in (PRODUCTS, ACCUM, ONE_BLOCK):
    assert pat in src, pat
variants = {
    "full": src,
    "one_block": src.replace(ONE_BLOCK, "constexpr int TC_MIN_BLOCKS = 1;"),
    "no_sums": src.replace(ACCUM, "      if (false) {"),
    "no_products": src.replace(PRODUCTS, """#pragma unroll
            for (int j = 0; j < 8; ++j) { s[j][0] = __uint_as_float(hi[j & 3][0] ^ lo[j & 3][1]); s[j][1] = s[j][0]; s[j][2] = s[j][0]; s[j][3] = s[j][0]; }"""),
}
procs = {}
for name, text in variants.items():
    (out / f"lloyd_{name}.cu").write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out / f"lib{name}.so"), str(out / f"lloyd_{name}.cu")]
    procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
res = {"nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()}
for name, p in procs.items():
    log, _ = p.communicate()
    lines = log.splitlines()
    i = max(j for j, l in enumerate(lines) if "lloyd_tc" in l and "Compiling" in l)
    res[f"{name} build"] = " ".join(l.split(":")[-1].strip() for l in lines[i + 1:i + 3]) + " " + " ".join(l[:90] for l in lines if "C75" in l)
    if p.returncode:
        print(name, "BUILD FAILED", log[-3000:])
        sys.exit(1)
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
sms = torch.cuda.get_device_properties(dev).multi_processor_count
sig = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
libs = {}
for name in variants:
    lib = ctypes.CDLL(str(out / f"lib{name}.so")); lib.heat_lloyd_tc.argtypes = sig; libs[name] = lib
def ms(fn, reps=20):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    for _ in range(reps): fn()
    s1.record(); s1.synchronize()
    return s0.elapsed_time(s1) / reps
for n, d, k in ((2_000_000, 64, 64), (20_011, 512, 1024)):
    protos = torch.randn((k, d), generator=g, device=dev) * 8
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = protos[lab] + torch.randn((n, d), generator=g, device=dev)
    c = protos + 0.1 * torch.randn((k, d), generator=g, device=dev)
    blocks = min(2 * sms, -(-n // 64))
    parts = torch.empty((blocks, k, d), device=dev); cparts = torch.empty((blocks, k), dtype=torch.int32, device=dev)
    sums = torch.empty((k, d), device=dev); counts = torch.empty((k,), device=dev)
    s_p, n_p = lloyd_update_plain(x, c)
    for name, lib in libs.items():
        run = lambda: lib.heat_lloyd_tc(x.data_ptr(), d, n, c.data_ptr(), k, blocks, parts.data_ptr(), cparts.data_ptr(), sums.data_ptr(), counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert run() == 0
        torch.cuda.synchronize()
        ok = bool(torch.equal(counts, n_p))
        t = [ms(run), ms(run)]
        res[f"{name} {n}x{d} k={k}"] = {"counts_equal": ok, "sums_max_abs_err": (sums - s_p).abs().max().item(), "ms": t}
        print(name, n, d, k, ok, t, flush=True)
    res[f"x read by torch (sum) {n}x{d}"] = ms(lambda: x.sum())
(out / "probe.json").write_text(json.dumps(res, indent=1))
