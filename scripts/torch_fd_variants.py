#!/usr/bin/env python3
"""Where the time of K1 and K2 at each tier goes, on the card.

    python3 scripts/torch_fd_variants.py [--tier highest ...] [--points 58368 ...]
        [--variants NAME ...] [--root DIR] [--outputs FILE]
        [--out exp/fd_variants.json]

Builds edited copies of ``neuraludf_tpu_torch/csrc/fused_distance.cu``
(``VARIANTS[tier]``: text substitutions, each a question about the tier's
route on the main-path net: 3xTF32 at "highest", bf16x3 at "high"; "route",
at every tier, is the package's own library, unedited) with ``nvcc`` for
sm_90a, all at once, into ``build/fd_variants/``; then, for each tier and
variant, times K1 and K2 at the tier on the
main-path net (the inputs of ``chip_smoke.check_kernels``; K2 at the first
point count only) with CUDA events, gives their largest error against the
explicit version at the tier (a variant that drops work is wrong on
purpose: its time is what the dropped work cost), and the device time of
each kernel of a call (torch.profiler); for "route" also the explicit
version's time and the CUDA launches of one call. Unless only "route" is
asked for, it also times one warpgroup MMA loop alone (``PEAK_SRC``: 2 x 12
tf32 ``wgmma`` m64n128k8 and m64n256k8, A from registers or from shared
memory, bf16 m64n256k16 beside them) on every SM, to show what the tensor
cores give this instruction.

``--root DIR`` runs "route" alone from another checkout of the port (an
older commit unpacked with ``git archive``): its source, its wrapper and its
``chip_smoke``, so that two versions are timed in one chip call, in turns.
``--outputs FILE`` keeps the route's K1 and K2 outputs there, or, where
FILE exists, compares them with the ones it holds bit for bit: running the
parent with it first and the change after says whether the change moved a
single bit. Prints one JSON line (also written to ``--out``) with the
card's name and power limit. Needs one CUDA card; imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TF32_TIER = "template <> struct XTier<ROUTE_TF32X3> { static constexpr int KS = 8, CH = 2, LEAD = 6; };"
B3_TIER = "template <> struct XTier<ROUTE_BF16X3> { static constexpr int KS = 16, CH = 4, LEAD = 4; };"
NO_LOADS = [("    cp_async16(dst + row * 64 + ((ch ^ ((row >> 1) & 3)) << 4), src + row * 16 + ch * 4);\n", "")]
# tier -> name -> [(text of the source, replacement)]
VARIANTS = {
    "default": {"route": []},
    "highest": {
        "route": [],
        # four k8 steps between two f32 flushes, in place of two
        "chunk4": [(TF32_TIER, TF32_TIER.replace("CH = 2, LEAD = 6", "CH = 4, LEAD = 4"))],
        # activate's polynomial logarithm in the forward epilogues
        "poly_softplus": [("  asm(\"lg2.approx.ftz.f32 %0, %1;\" : \"=f\"(l) : \"f\"(1.f + t));\n"
                           "  sg = a >= 0.f ? r : t * r;\n"
                           "  h = fmaf(l, 6.9314718055994531e-3f, fmaxf(a, 0.f));",
                           "  (void)l;\n  activate(a, h, sg);")],
        # no products of the sweeps (the small passes and the big ones)
        "no_sweep_mma": [("        wgmma_tf32<N>(acc2, al[q], make_desc64(sb[q]), q != 0);\n"
                          "        wgmma_tf32<N>(acc2, ah[q], make_desc64(sb[q] + 32), 1);\n", ""),
                         ("      if (q < c) wgmma_tf32<N>(acc2, ah[q], make_desc64(sb[q]), 1);", "      ;")],
        # no weight slices loaded into the sweeps' ring
        "no_sweep_loads": NO_LOADS,
    },
    "high": {
        "route": [],
        # two k16 steps a chunk, six slices ahead, in place of four and four
        "chunk2": [(B3_TIER, B3_TIER.replace("CH = 4, LEAD = 4", "CH = 2, LEAD = 6"))],
        # no products of the sweeps (forward and reverse)
        "no_sweep_mma": [("        wgmma_bf16<N>(acc, ah[q], make_desc64(sb[q]), 1);\n"
                          "        wgmma_bf16<N>(acc2, ah[q], make_desc64(sb[q] + 32), 1);\n", ""),
                         ("        wgmma_bf16<N>(acc, al[q], make_desc64(sb[q]), 1);\n"
                          "        wgmma_bf16<N>(acc, ah[q], make_desc64(sb[q] + 32), 1);\n", ""),
                         ("      if (q < c) wgmma_bf16<N>(acc, ah[q], make_desc64(sb[q]), 1);", "      ;")],
        # no weight slices loaded into the sweeps' ring
        "no_sweep_loads": NO_LOADS,
    },
}

PEAK_SRC = r'''
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
template <int N> struct Mma;
template <> struct Mma<128> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {REGS64}, {%64, %65, %66, %67}, %68, 1, 1, 1;\n"
                 : OUTS64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {REGS64}, %64, %65, 1, 1, 1;\n"
                 : OUTS64 : "l"(a), "l"(b));
  }
};
template <> struct Mma<256> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {REGS128}, {%128, %129, %130, %131}, %132, 1, 1, 1;\n"
                 : OUTS128 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {REGS128}, %128, %129, 1, 1, 1;\n"
                 : OUTS128 : "l"(a), "l"(b));
  }
  static __device__ __forceinline__ void bf16(float* d, uint64_t a, uint64_t b) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {REGS128}, %128, %129, 1, 1, 1, 0, 0;\n"
                 : OUTS128 : "l"(a), "l"(b));
  }
};
// MODE 0: tf32, A from registers; 1: tf32, A from shared memory; 2: bf16
template <int MODE, int N>
__global__ void __launch_bounds__(256, 1) loop(int iters, float* out) {
  extern __shared__ __align__(1024) uint8_t sm[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(sm) + 1023) & ~1023u;
  for (int i = threadIdx.x; i < 16384; i += 256) ((float*)sm)[i] = 0.001f * (i % 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  const uint64_t da = desc(base + (threadIdx.x >> 7) * 8192), db = desc(base + 16384);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      if (MODE == 0) Mma<N>::rs(acc, a, db + 2 * (q & 3));
      if (MODE == 1) Mma<N>::ss(acc, da + 2 * (q & 3), db + 2 * (q & 3));
      if constexpr (MODE == 2) Mma<256>::bf16(acc, da + 2 * (q & 3), db + 2 * (q & 3));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
template <int MODE, int N>
void run(const char* name, int k, float* out, int sms) {
  cudaFuncSetAttribute(loop<MODE, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, 66560);
  const int iters = 2000;
  loop<MODE, N><<<sms, 256, 66560>>>(10, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  loop<MODE, N><<<sms, 256, 66560>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 64 * N * k * 12.0 * iters * 2 * sms;
  printf("{\"mma\": \"%s\", \"ms\": %.4f, \"tflops\": %.1f, \"error\": \"%s\"}\n", name, ms,
         flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 256 * 4);
  run<0, 128>("tf32 m64n128k8, A in registers", 8, out, sms);
  run<1, 128>("tf32 m64n128k8, A in shared memory", 8, out, sms);
  run<0, 256>("tf32 m64n256k8, A in registers", 8, out, sms);
  run<2, 256>("bf16 m64n256k16, A in shared memory", 16, out, sms);
  return 0;
}
'''


def peak_source() -> str:
    regs = lambda n: ", ".join(f"%{i}" for i in range(n))
    outs = lambda n: ", ".join(f'"+f"(d[{i}])' for i in range(n))
    return (PEAK_SRC.replace("REGS128", regs(128)).replace("REGS64", regs(64))
            .replace("OUTS128", outs(128)).replace("OUTS64", outs(64)))


def nvcc(args) -> subprocess.CompletedProcess:
    from neuraludf_tpu_torch.ops import build
    return subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                           "-O3"] + args, capture_output=True, text=True)


def build_variant(root: Path, out: Path, name: str, subs) -> Path:
    src = (root / "neuraludf_tpu_torch" / "csrc" / "fused_distance.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: its text is not in the source: {old[:60]!r}")
        src = src.replace(old, new)
    (out / f"{name}.cu").write_text(src)
    lib = out / f"lib{name}.so"
    r = nvcc(["-shared", "-Xcompiler", "-fPIC", "-I", str(root / "neuraludf_tpu_torch" / "csrc"),
              "-o", str(lib), str(out / f"{name}.cu")])
    if r.returncode:
        raise SystemExit(f"variant {name} does not build:\n{r.stderr[-3000:]}")
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """The library with the argument types ``fused_distance.library`` sets."""
    from neuraludf_tpu_torch.ops import fused_distance as fd
    lib = ctypes.CDLL(str(path))
    ref = fd.library()
    for fn in ("fd_scratch_bytes", "fd_forward", "fd_backward"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    return lib


def compare_outputs(path: Path, outputs: dict) -> dict:
    """Keeps outputs at path, or compares them bit for bit with the ones
    kept there: per kernel and point count, equal or the largest
    difference."""
    import torch
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, path)
        return {"kept": str(path)}
    kept = torch.load(path)
    result = {}
    for key, outs in outputs.items():
        pairs = list(zip(outs, kept[key]))
        result[key] = {"bit_equal": all(torch.equal(a, b) for a, b in pairs),
                       "max_abs_diff": max(float((a - b).abs().max()) for a, b in pairs)}
    return {"compared_with": str(path), "outputs": result}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", choices=sorted(VARIANTS), nargs="+", default=["highest"])
    ap.add_argument("--points", type=int, nargs="+", default=[58368])
    ap.add_argument("--variants", nargs="+", default=None)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--outputs", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    names = {tier: args.variants or list(VARIANTS[tier]) for tier in args.tier}
    peak_loop = any(v != ["route"] for v in names.values())
    if root != ROOT and peak_loop:
        raise SystemExit("--root runs the unedited route alone: --variants route")
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_fd_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from neuraludf_tpu_torch import config as config_mod
    from neuraludf_tpu_torch.ops import build
    from neuraludf_tpu_torch.ops import fused_distance as fd
    from torch.profiler import ProfilerActivity, profile

    out_dir = root / "build" / "fd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    # "route" is the package's own library; each edited variant a library of its own
    edited = {(tier, name): VARIANTS[tier][name] for tier in args.tier for name in names[tier]
              if name != "route"}
    (out_dir / "peak.cu").write_text(peak_source())
    with ThreadPoolExecutor(len(edited) + 2) as pool:
        peak = pool.submit(nvcc, ["-o", str(out_dir / "peak"), str(out_dir / "peak.cu")]) \
            if peak_loop else None
        own = pool.submit(build.compile_sources, ["fused_distance"])
        libs = dict(zip(edited, pool.map(
            lambda kv: build_variant(root, out_dir, f"{kv[0][0]}_{kv[0][1]}", kv[1]),
            edited.items())))
        own.result()
        peak = peak.result() if peak_loop else None
    if peak is not None and peak.returncode:
        raise SystemExit(f"the MMA loop does not build:\n{peak.stderr[-3000:]}")
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    card = cs.card_line()
    mma = [json.loads(line) for line in subprocess.run(
        [str(out_dir / "peak")], capture_output=True, text=True, check=True).stdout.splitlines()
    ] if peak_loop else []

    ucfg = config_mod.load(str(cs.CONF)).model.udf_network
    library = fd.library
    results, outputs = {}, {}
    try:
        for tier in args.tier:
            for i, n in enumerate(args.points):
                fd.library = library
                _, kin = cs.check_kernels(ucfg, torch.device("cuda:0"), n, backward=i == 0,
                                          tiers=(tier,))
                x, wflat, bflat, lay = kin["x"], kin["wflat"], kin["bflat"], kin["lay"]
                cot = (kin["ubar"], kin["fbar"], kin["gbar"])
                plain = {"K1": lambda: fd.explicit_forward(x, wflat, bflat, lay, tier)}
                calls = {"K1": lambda: fd.fused_forward(x, wflat, bflat, lay, tier)}
                if i == 0:
                    plain["K2"] = lambda: fd.explicit_backward(x, wflat, bflat, lay, tier, *cot)
                    calls["K2"] = lambda: fd.fused_backward(x, wflat, bflat, lay, tier, *cot)
                with torch.no_grad():
                    ref = {k: f() for k, f in plain.items()}
                    for name in names[tier]:
                        if name == "route":
                            fd.library = library
                        else:
                            lib = bind(libs[(tier, name)])
                            fd.library = lambda lib=lib: lib
                        for k, call in calls.items():
                            out = call()
                            err = max(float((a - b).abs().max() / b.abs().max())
                                      for a, b in zip(out, ref[k]))
                            ms = [cs.cuda_ms(call) for _ in range(2)]
                            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                                for _ in range(3):
                                    call()
                                torch.cuda.synchronize()
                            kernels = {e.key.split("(")[0]: e.self_device_time_total / 3e3
                                       for e in prof.key_averages()
                                       if e.device_type == torch.autograd.DeviceType.CUDA
                                       and e.self_device_time_total > 0}
                            row = {"ms": ms, "max_rel_err": err, "kernels_ms": kernels}
                            if name == "route":
                                row["plain_ms"] = cs.cuda_ms(plain[k], 3)
                                row["cuda_launches_per_call"] = cs.cuda_launches(call)
                                outputs[f"{tier}/{k}@{n}"] = tuple(t.cpu() for t in out)
                            results.setdefault(tier, {}).setdefault(name, {})[f"{k}@{n}"] = row
                            print(f"{tier:8s} {name:16s} {k} N={n} {ms[0]:.3f} {ms[1]:.3f} ms  "
                                  f"max rel. err {err:.2e}  {kernels}  [{card}]", flush=True)
                del ref, x, wflat, bflat, cot, kin
    finally:
        fd.library = library
    lay = fd.layout_for(ucfg)
    line = {"card": card, "root": str(root), "routes": {t: fd.route_for(lay, t) for t in args.tier},
            "points": args.points, "mma_loop": mma, "variants": results,
            "seconds": time.time() - t0}
    if args.outputs and outputs:
        line["outputs"] = compare_outputs(Path(args.outputs), outputs)
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
