"""Where the tensor-core cdist kernel's time goes: variants of cdist_tc with parts removed.

Run from the root of the repository, on a machine with a CUDA card:

    python3 tools/probe_cdist_variants.py

It writes variants of heat_tpu_torch/csrc/cdist.cu into build/probe/ (the
kernel as it is; without the bulk stores; without the products; without
the epilogue's arithmetic; without the epilogue; the pre-pass alone;
without the load of y's lo halves),
builds each with the package's nvcc flags, runs each at the main path's
cdist (16,384 x 128 f32 against itself, "dist") in 3xTF32 and in one TF32
pass, and prints, per variant, its time (CUDA events, two rounds of 10
launches) and its largest deviation from the full kernel, beside two
yardsticks: writing the 1.07 GB output once (``fill_``) and ``torch.cdist``.
Variants without a part give wrong results by design; they show what the
rest costs. The results also go to build/probe/cdist_probe.json.
"""
import ctypes, json, os, subprocess, sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
import torch
from heat_tpu_torch import _build
from heat_tpu_torch.spatial import cuda_cdist

src = (_build.CSRC / "cdist.cu").read_text()
out = Path("build/probe")
out.mkdir(parents=True, exist_ok=True)
PRODUCTS = src[src.index("        wgmma_fence();\n#pragma unroll\n        for (int kq"):
               src.index("        wgmma_wait<0>();\n") + len("        wgmma_wait<0>();\n")]
FAKE = """#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = (pn ? acc[j][e] : 0.f) + __uint_as_float(hi[j & 3][e] ^ lo[j & 3][e]);
"""
STORE = """            tma_store_2d(&map_out, panel + wr * 128, col0 + pc * TC_PANEL, row0 + wg * 64 + wr);"""
MATH = """  const float d2 = fmaxf(fmaf(-2.f, dot, x2 + y2), 0.f);
  if (rbf) return expf(-gamma * d2);
  float r;
  asm("sqrt.approx.f32 %0, %1;\\n" : "=f"(r) : "f"(d2));
  return r;"""
EPILOGUE = "      fence_regs(acc);\n"
LAUNCH = "  cdist_tc<kSplit, kBulkStore><<<blocks"
YLO_TX = "      constexpr uint32_t kTx = (kSplit ? 3 : 2) * TC_PANEL_BYTES;"
YLO_LOAD = "          if (kSplit)\n            tma_load_2d(st + 2 * TC_PANEL_BYTES"
for pat in (PRODUCTS, STORE, MATH, EPILOGUE, LAUNCH, YLO_TX, YLO_LOAD):
    assert pat in src, pat
variants = {
    "full": src,
    "no_store": src.replace(STORE, "            (void)wr;"),
    "no_products": src.replace(PRODUCTS, FAKE),
    "no_math": src.replace(MATH, "  return x2 + y2 + dot + gamma * rbf;"),
    "no_epilogue": src.replace(EPILOGUE, EPILOGUE + "      if (acc[0][0] == 1234.5f) out[t] = acc[15][3];\n      continue;\n"),
    "prepass_only": src.replace(LAUNCH, "  if (tiles > 0) return cudaSuccess;\n" + LAUNCH),
    # y_lo is not loaded (its slot keeps whatever it held): two thirds of
    # the loads, the same products, stores and epilogue
    "no_ylo_load": src.replace(YLO_TX, YLO_TX.replace("kSplit ? 3", "kSplit ? 2")).replace(
        YLO_LOAD, "          if (false)\n            tma_load_2d(st + 2 * TC_PANEL_BYTES"),
}
procs = {}
for name, text in variants.items():
    (out / f"cdist_{name}.cu").write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out / f"libcdist_{name}.so"), str(out / f"cdist_{name}.cu")]
    procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
res = {"nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True).stdout.strip()}
for name, p in procs.items():
    log, _ = p.communicate()
    if p.returncode:
        print(name, "BUILD FAILED", log[-3000:])
        sys.exit(1)
    lines = log.splitlines()
    res[f"{name} build"] = [l.split(":")[-1].strip() for i, l in enumerate(lines)
                            if "Used" in l and "cdist_tcILb1ELb1E" in lines[i - 2]]
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
m, k = 16384, 128
x = torch.rand((m, k), generator=g, device=dev)
kp, pad = 128, 16384
yhi = torch.empty((m, kp), device=dev)
ylo = torch.empty((m, kp), device=dev)
yn = torch.empty((pad,), device=dev)
o = torch.empty((m, m), device=dev)
stream = torch.cuda.current_stream(dev).cuda_stream


def time_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(2):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / reps)
    return ts


ref = {}
for split in (1, 0):
    for name in variants:
        lib = ctypes.CDLL(str(out / f"libcdist_{name}.so"))
        fn = lib.heat_cdist_tc
        fn.argtypes = cuda_cdist._SIGNATURES["heat_cdist_tc"]
        fn.restype = ctypes.c_int

        def run():
            rc = fn(x.data_ptr(), x.data_ptr(), yhi.data_ptr(), ylo.data_ptr(), yn.data_ptr(),
                    yn.data_ptr(), o.data_ptr(), m, m, k, 1, 0, 0.0, split, stream)
            assert rc == 0, rc

        o.zero_()
        run()
        torch.cuda.synchronize()
        if name == "full":
            ref[split] = o.clone()
        dev_err = (o - ref[split]).abs().max().item()
        res[f"{name} split={split}"] = {"ms": time_ms(run), "max_dev_from_full": dev_err}
        print(name, split, res[f"{name} split={split}"], flush=True)
res["fill_ ms (write 1.07 GB)"] = time_ms(lambda: o.fill_(1.0))
torch.backends.cuda.matmul.allow_tf32 = False
res["torch.cdist ms"] = time_ms(lambda: torch.cdist(x, x))
print(json.dumps(res, indent=1))
(out / "cdist_probe.json").write_text(json.dumps(res, indent=1))
