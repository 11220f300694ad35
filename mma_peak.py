#!/usr/bin/env python3
"""The issue rate of mma.sync on one card: HMMA instructions a clock per SM.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 mma_peak.py

The 3xTF32 kernels of the port (K1's float32 forward and backward, K4's
float32 passes) run their products as ``mma.sync.m16n8k8`` TF32.  What the
card can issue of that instruction bounds them, whatever the kernel around
it does.  This script builds one small CUDA file (written below, into
``build/mma_peak/``) whose kernel does nothing but mma.sync on registers:
every warp runs ``iters`` rounds of ``chains`` independent accumulators,
so a round has ``chains`` products in flight.  With every block resident at
once (``blocks`` a multiple of the SMs, small enough to fit), the HMMA a
clock per SM is the products an SM's warps issue over the longest block's
``clock64`` cycles.  It sweeps warps an SM and chains for TF32
(m16n8k8) and, as a yardstick, bf16 (m16n8k16), and prints one JSON line
per point, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
BUILD = ROOT / "build" / "mma_peak"

SOURCE = r"""
#include <stdint.h>
#include <cuda_runtime.h>

template <int CHAINS, bool TF32>
__global__ void mma_loop(float* out, long long* cycles, int iters) {
  float d[CHAINS][4];
  uint32_t a[4], b[2];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[c][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  b[0] = __float_as_uint(1e-3f * threadIdx.x);
  b[1] = __float_as_uint(2e-3f * threadIdx.x);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int CHAINS>
int launch(int tf32, float* out, long long* cycles, int blocks, int threads,
           int iters, cudaStream_t stream) {
  if (tf32)
    mma_loop<CHAINS, true><<<blocks, threads, 0, stream>>>(out, cycles, iters);
  else
    mma_loop<CHAINS, false><<<blocks, threads, 0, stream>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}

extern "C" int mma_peak(int tf32, int chains, float* out, long long* cycles,
                        int blocks, int threads, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch<1>(tf32, out, cycles, blocks, threads, iters, st);
    case 2: return launch<2>(tf32, out, cycles, blocks, threads, iters, st);
    case 4: return launch<4>(tf32, out, cycles, blocks, threads, iters, st);
    case 8: return launch<8>(tf32, out, cycles, blocks, threads, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def build() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "mma_peak.cu", BUILD / "libmma_peak.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    dll.mma_peak.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    return dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_peak: no CUDA card", file=sys.stderr)
        return 2
    dll = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for tf32 in (1, 0):
        for warps_per_sm in (4, 8, 16):
            for chains in (1, 2, 4, 8):
                blocks, threads = n_sm * (warps_per_sm // 4), 128
                out = torch.empty(blocks * threads, device="cuda")
                cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
                for _ in range(2):                     # the first call warms up
                    err = dll.mma_peak(tf32, chains, out.data_ptr(), cycles.data_ptr(),
                                       blocks, threads, iters, stream)
                    if err:
                        raise RuntimeError(f"mma_peak launch failed: {err}")
                torch.cuda.synchronize()
                per_sm = warps_per_sm * iters * chains
                clk = int(cycles.max())
                print(json.dumps({
                    "mma": "m16n8k8 tf32" if tf32 else "m16n8k16 bf16",
                    "warps_per_sm": warps_per_sm, "chains": chains,
                    "hmma_per_clock_per_sm": round(per_sm / clk, 4),
                    "cycles": clk}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
