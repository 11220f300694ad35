#!/usr/bin/env python3
"""Where K4's bf16 kernels and K1's float32 forward spend their time, on the card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 kernel_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` into
``build/kernel_phases/`` with a timestamp (``%globaltimer``, ns) written by
one thread of every block at each phase boundary, runs K4 through its
wrapper at the Mamba-2 prefill shape on that copy, and prints one JSON line
per kernel: when its blocks started and ended (µs from the first block of
the call) and, for each mark, the mean time since its block started.  The
marks are placed by matching lines of the source; a mark whose line is gone
stops the script with that line.  Then, as a yardstick, one streaming copy
kernel reads 192 KB per block through a 4-stage ``cp.async`` ring (the load
pattern of the K4 kernels), at 16 and 128 blocks: what L2 delivers per block
and in all.

K1's float32 forward (``flash_fwd_f32_mma_kernel`` in
``src/repro_torch/kernels/csrc/flash_attention.cu``) is patched the same
way into ``build/kernel_phases/``, with each warp adding the ``clock64``
cycles it spends in each phase of its tile loop (the wait for the tile and
the barrier, S = Q K^T, the softmax, the second barrier or a skipped tile,
P V); it runs through its wrapper at ``chip_smoke.TRAIN_BWD``'s llama3-8b
and quickstart shapes and prints, per shape, each phase's cycles a warp and
share, and the HMMA a clock one warp issues in S and in P V.  K1's bf16
backward (``flash_bwd_dkdv_wgmma_kernel`` and ``flash_bwd_dq_wgmma_kernel``
in ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``) is patched the
same way, each warp of a one-warpgroup block adding the cycles of each
phase of its step (the tiles' wait, the products issued and retired, the
next step's copies, the softmax, dS); it prints, at the same two shapes,
each phase's cycles a warp and step and its share.  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k1  # noqa: E402
from repro_torch.kernels import ssd_chunk as k4  # noqa: E402

OUT = ROOT / "build" / "kernel_phases"
SLOTS = 32                      # marks a block

PROF = r'''
__device__ unsigned long long* g_marks[2];
// thread `who` of the block writes the time at mark k
__device__ __forceinline__ void mark(int kern, int k, int who = 0) {
  if (threadIdx.x == who && g_marks[kern]) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const size_t blk = blockIdx.x + gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
    g_marks[kern][blk * 32 + k] = t;
  }
}
'''
EXTERN = r'''
extern "C" int phases_set(void* a, void* b) {
  void* h[2] = {a, b};
  return (int)cudaMemcpyToSymbol(g_marks, h, sizeof(h));
}
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
'''
# (kernel, mark, label, source line, insert after the line?); kernel 0 is the
# chunk-state kernel (thread 0 marks), kernel 1 the chunk scan (thread 128:
# warpgroup 1, row tile 1 at the path shape).  A mark "a+bjt" repeats for each
# tile jt at a + b jt.
MARKS = [
    (0, "0", "start", "  const int ntiles = (len + T - 1) / T;\n", True),
    (0, "1", "dt loaded", "    run += dtv[k] * a;\n    loc[k] = run;\n  }\n", True),
    (0, "2", "cums scanned", "#pragma unroll\n  for (int k = 0; k < 8; ++k) {\n"
     "    const int i = tid * per + k;\n"
     "    if (k < per && i < QP) w[i] = dtv[k] * expf(last - cums[i]);\n", False),
    (0, "3", "w computed", "  if (tid == 0) ws_last[(size_t)bh * nc + c] = last;"
     "   // each P tile's carry reads it\n", True),
    (0, "4+2jt", "tile jt in shared memory",
     "tile jt (and w) for every thread; tile jt-1's readers done\n", True),
    (0, "5+2jt", "tile jt's products done",
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(acc);\n  }\n"
     "  // S^ through shared memory", False),
    (0, "20", "S^ stored", "  // the carry, by the last block", False),
    (0, "21", "last ticket drawn (carry blocks)",
     "  // (which bypass L1).\n  __syncthreads();\n  unsigned ticket = 0;\n"
     "  unsigned* counter = counters + (size_t)bh * npt + pt;\n"
     "  if (tid == 0) ticket = sm90::atomic_add_acq_rel(counter, 1u);\n"
     "  if (!__syncthreads_or(tid == 0 && ticket == (unsigned)nc - 1)) return;\n", True),
    (0, "23", "carry: chunks walked", "  if (state_out != nullptr) {\n#pragma unroll\n"
     "    for (int k = 0; k < GPT; ++k) {\n      const int g", False),
    (0, "22", "carry done", "        if (p + 3 < P) dst[3] = sv[k].w;\n      }\n    }\n  }\n"
     "  if (tid == 0) *counter = 0u;\n", True),
    (1, "0", "start", "  if (it0 >= ntl) return;                      // past the ragged edge\n",
     True),
    (1, "1", "input copies issued", '      asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n',
     False),
    (1, "2", "kernel 1 ended (griddepcontrol.wait returned)",
     '      asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n', True),
    (1, "3", "cums in shared memory", "  const uint32_t sC = sbase + wg * NB;\n", True),
    (1, "4+4jt", "tile jt in shared memory", "tile jt (C, cums) for every thread; jt-1 done\n",
     True),
    (1, "5+4jt", "scores of tile jt done", "    // o L o dt_j, masked before exp", False),
    (1, "6+4jt", "scores of tile jt masked and rounded", "    const uint32_t sx = sB + NB;\n",
     True),
    (1, "7+4jt", "P x of tile jt done",
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(acc);\n  }\n\n  if (inter) {", False),
    (1, "28", "carried-state term done, y next", "  if (!live) return;\n\n  bf16* yb",
     False),
]

# K1's float32 forward: phase cycles a warp.  (phase, source line, insert
# after the line?); the lap adds the cycles since the last lap to its phase,
# after the values it names are computed
K1_PROF = r"""
__device__ unsigned long long k1_cycles[8];   // phases 0-4, warps, live warp-tiles
__device__ __forceinline__ void k1_lap(unsigned long long& acc, long long& t) {
  const long long now = clock64();
  acc += now - t;
  t = now;
}
template <int N>
__device__ __forceinline__ void k1_after(const float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"f"(x[i][0]), "f"(x[i][1]), "f"(x[i][2]), "f"(x[i][3]));
}
"""
K1_EXTERN = r"""
extern "C" int k1_cycles_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k1_cycles, sizeof(k1_cycles));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k1_cycles, zero, sizeof(zero));
  return (int)e;
}
"""
K1_PHASES = ["tile wait and barrier", "S = Q K^T", "softmax",
             "second barrier or skipped tile", "P V"]
K1_MARKS = [
    ("  float l[2] = {0.f, 0.f};           // this thread's columns only; summed at the end\n",
     True, "  unsigned long long k1c[5] = {0, 0, 0, 0, 0};\n  unsigned long long k1n = 0;\n"
     "  long long k1t = clock64();\n"),
    ("    const float* Ks = stages + stage * C::STAGE_WORDS;\n", False,
     "    k1_lap(k1c[0], k1t);\n"),
    ("      // soft-cap, log2(e), mask (only on tiles that cross an edge), row max\n", False,
     "      k1_after(sacc);\n      k1_lap(k1c[1], k1t);\n      ++k1n;\n"),
    ("    if (C::STAGES == 1) {\n      sm90::cp_async_wait<0>();  // V(kt) landed\n", False,
     "    k1_after(sacc);\n    k1_lap(k1c[2], k1t);\n"),
    ("    if (!live) continue;\n", False, "    k1_lap(k1c[3], k1t);\n"),
    ("                     tf32x3::load_b_perm(Vs, RSV, 8 * j, ch * C::DVW + 8 * n, lane));\n"
     "    }\n", True, "    k1_after(oacc);\n    k1_lap(k1c[4], k1t);\n"),
    ("  sm90::cp_async_wait<0>();\n\n  if (wr0 >= S) return;\n", False,
     "  if (lane == 0) {\n    for (int i = 0; i < 5; ++i) atomicAdd(&k1_cycles[i], k1c[i]);\n"
     "    atomicAdd(&k1_cycles[5], 1ull);\n    atomicAdd(&k1_cycles[6], k1n);\n  }\n"),
]


def k1_patched_library() -> ctypes.CDLL:
    """flash_attention.cu with K1_MARKS' laps in the float32 kernel."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    src = src.replace("namespace {\n", K1_PROF + "namespace {\n", 1)
    for line, after, code in K1_MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"K1 lap: the line {line!r} is not in the source exactly once")
        src = src.replace(line, line + code if after else code + line)
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    (OUT / "flash_attention.cu").write_text(src + K1_EXTERN)
    lib = nvcc_shared(OUT / "flash_attention.cu", OUT / "libk1phases.so")
    lib.flash_attention_fwd.argtypes = build._SIGNATURES["flash_attention_fwd"]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.k1_cycles_read.argtypes = [ctypes.c_void_p]
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def k1_phases(lib) -> None:
    """K1's float32 forward with lse at the llama3-8b and quickstart training
    shapes, through the wrapper on the patched copy."""
    out = (ctypes.c_ulonglong * 8)()
    for label, b, s, h, kv, hd, _, _, _, _ in cs.TRAIN_BWD[:2]:
        q, k, v = (cs.normal(shape, torch.float32, seed) for shape, seed in (
            ((b, s, h, hd), 21), ((b, s, kv, hd), 22), ((b, s, kv, hd), 23)))
        k1.flash_attention_lse(q, k, v)
        torch.cuda.synchronize()
        lib.k1_cycles_read(out)                # zeroes the counters
        k1.flash_attention_lse(q, k, v)
        torch.cuda.synchronize()
        lib.k1_cycles_read(out)
        warps, tiles = out[5], out[6]
        total = sum(out[i] for i in range(5))
        hmma = 3 * 4 * (hd // 8 + hd // 8)     # one warp-tile: S and P V
        print(json.dumps({
            "kernel": "flash_fwd_f32_mma_kernel", "shape": label, "warps": warps,
            "live_warp_tiles": tiles,
            "cycles_a_warp": {n: round(out[i] / warps) for i, n in enumerate(K1_PHASES)},
            "share": {n: round(out[i] / total, 3) for i, n in enumerate(K1_PHASES)},
            "hmma_a_clock_of_one_warp": {
                "S": round(tiles * hmma / 2 / out[1], 4),
                "P V": round(tiles * hmma / 2 / out[4], 4)},
            "patched_us": round(1e3 * cs.graph_ms(lambda: k1.flash_attention_lse(q, k, v),
                                                  20), 2)}))


# K1's bf16 backward (flash_attention_bwd.cu): phase cycles a warp and step
# of the one-warpgroup walks (kv_walk<.., 3>, q_walk<.., 3>).  (source line,
# insert after the line?, code); a lap adds the cycles since the last lap
K1B_PROF = r"""
__device__ unsigned long long k1b_cycles[2][12];  // [dK/dV, dQ][phases, warps, steps]
__device__ __forceinline__ void k1b_lap(unsigned long long& acc, long long& t) {
  const long long now = clock64();
  acc += now - t;
  t = now;
}
"""
K1B_EXTERN = r"""
extern "C" int k1b_cycles_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k1b_cycles, sizeof(k1b_cycles));
  static const unsigned long long zero[24] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k1b_cycles, zero, sizeof(zero));
  return (int)e;
}
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
"""
K1B_PHASES = {
    "flash_bwd_dkdv_wgmma_kernel": [
        "tiles' wait and barrier", "s^T, dP^T issued; s^T (and the last dV, dK) retired",
        "barrier, next copies issued", "P^T, dV issued", "dP^T retired, dS^T, dK issued",
        "last products drained"],
    "flash_bwd_dq_wgmma_kernel": [
        "tiles' wait and barrier", "s, dP issued; s (and the last dQ) retired",
        "barrier, next copies issued", "P (1 - tanh^2)", "dP retired, dS",
        "dQ issued", "last products drained"],
}
K1B_RECORD = ("  if constexpr (WHAT == 3) {{\n    if ((x.tid & 31) == 0) {{\n"
              "      for (int i = 0; i < {n}; ++i) atomicAdd(&k1b_cycles[{k}][i], kbc[i]);\n"
              "      atomicAdd(&k1b_cycles[{k}][10], 1ull);\n"
              "      atomicAdd(&k1b_cycles[{k}][11], (unsigned long long)x.n_steps);\n"
              "    }}\n  }}\n")
K1B_INIT = ("  unsigned long long kbc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
            "  long long kbt = clock64();\n")
K1B_MARKS = [
    # dK/dV walk
    ("  uint32_t pa[4][4], sa[4][4];\n", True, K1B_INIT),
    ("    const uint32_t sQ = x.sSt + stage * C::TILES, sO = sQ + C::QK_BYTES;\n", False,
     "    k1b_lap(kbc[0], kbt);\n"),
    ("    bar_sync(1, NT);\n    if (step + 1 < x.n_steps) kv_load<DQK, DV, NT>(x, step + 1, "
     "stage ^ 1);\n", False, "    k1b_lap(kbc[1], kbt);\n"),
    ("    // P^T, and dV += P^T dO (dO read MN-major) while dP^T runs\n", False,
     "    k1b_lap(kbc[2], kbt);\n"),
    ("    // dS^T, and dK += dS^T q (q read MN-major)\n", False, "    k1b_lap(kbc[3], kbt);\n"),
    ("      mma_cols<OK, NOK>(dk, sa, sQ, 0);\n      sm90::wgmma_commit();\n    }\n", True,
     "    k1b_lap(kbc[4], kbt);\n"),
    ("  sm90::wgmma_wait<0>();\n  if constexpr (KEEP_V) fence_all(dv);\n"
     "  if constexpr (KEEP_K) fence_all(dk);\n", True,
     "  k1b_lap(kbc[5], kbt);\n" + K1B_RECORD.format(n=6, k=0)),
    # dQ walk
    ("  uint32_t sa[4][4];   // dS as bf16 A fragments, rewritten after dQ's retires\n", True,
     K1B_INIT),
    ("    const uint32_t sK = x.sSt + stage * C::TILES, sV = sK + C::QK_BYTES;\n", False,
     "    k1b_lap(kbc[0], kbt);\n"),
    ("    bar_sync(1, NT);\n    if (step + 1 < x.n_steps)\n      q_load<DQK, DV, NT>", False,
     "    k1b_lap(kbc[1], kbt);\n"),
    ("    // P (1 - tanh^2) in place of s; the roles trade it for dP\n", False,
     "    k1b_lap(kbc[2], kbt);\n"),
    ("    if constexpr (WHAT == 3) {\n      sm90::wgmma_wait<0>();    // dP retired\n", False,
     "    k1b_lap(kbc[3], kbt);\n"),
    ("    // dQ += dS k over this warpgroup's columns: k read MN-major\n", False,
     "    k1b_lap(kbc[4], kbt);\n"),
    ("    mma_cols<OQ, NOQ>(dq, sa, sK, role * (W / 64));\n    sm90::wgmma_commit();\n", True,
     "    k1b_lap(kbc[5], kbt);\n"),
    ("  sm90::wgmma_wait<0>();\n  fence_all(dq);\n", True,
     "  k1b_lap(kbc[6], kbt);\n" + K1B_RECORD.format(n=7, k=1)),
]


def k1b_patched_library() -> ctypes.CDLL:
    """flash_attention_bwd.cu with K1B_MARKS' laps in the bf16 walks."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    src = src.replace("namespace {\n", K1B_PROF + "namespace {\n", 1)
    for line, after, code in K1B_MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"K1 bwd lap: the line {line!r} is not in the source "
                               "exactly once")
        src = src.replace(line, line + code if after else code + line)
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    (OUT / "flash_attention_bwd.cu").write_text(src + K1B_EXTERN)
    lib = nvcc_shared(OUT / "flash_attention_bwd.cu", OUT / "libk1bphases.so")
    lib.flash_attention_bwd.argtypes = build._SIGNATURES["flash_attention_bwd"]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.k1b_cycles_read.argtypes = [ctypes.c_void_p]
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def k1b_phases(lib) -> None:
    """K1's bf16 backward at the llama3-8b and quickstart training shapes,
    through the wrapper on the patched copy (o and lse from the forward of
    the built library)."""
    out = (ctypes.c_ulonglong * 24)()
    load = build.load
    for label, b, s, h, kv, hd, hd_v, window, cap, scale in cs.TRAIN_BWD[:2]:
        q, k, v, do = (cs.normal(shape, torch.bfloat16, seed) for shape, seed in (
            ((b, s, h, hd), 21), ((b, s, kv, hd), 22), ((b, s, kv, hd_v), 23),
            ((b, s, h, hd_v), 24)))
        kw = dict(causal=True, window=window, logit_cap=cap, scale=scale)
        build.load = load
        o, lse = k1.flash_attention_lse(q, k, v, **kw)
        build.load = lambda: lib      # the backward launches the patched copy

        def bwd():
            return k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)

        bwd()
        torch.cuda.synchronize()
        lib.k1b_cycles_read(out)               # zeroes the counters
        bwd()
        torch.cuda.synchronize()
        lib.k1b_cycles_read(out)
        for kern, (name, phases) in enumerate(K1B_PHASES.items()):
            row = out[12 * kern:12 * kern + 12]
            warps, steps = row[10], row[11]
            total = sum(row[i] for i in range(len(phases)))
            print(json.dumps({
                "kernel": name, "shape": label,
                "heads_a_dkdv_item": k1.bwd_heads_per_item(b, s, h, kv),
                "warps": warps, "warp_steps": steps,
                "cycles_a_warp_step": {n: round(row[i] / steps) for i, n in enumerate(phases)},
                "share": {n: round(row[i] / total, 3) for i, n in enumerate(phases)},
                "patched_us": round(1e3 * cs.graph_ms(bwd, 20), 2)}))
    build.load = load


YARDSTICK = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// each block streams `per_block` bytes of src through a 4-stage ring of
// 16 KB tiles of 16-byte cp.async, as the K4 kernels load their tiles
__global__ void stream(const uint4* src, int per_block, unsigned* sink) {
  extern __shared__ uint4 ring[];
  constexpr int ST = 4, TILE = 1024;      // 16-byte chunks a tile
  const uint4* b = src + (size_t)blockIdx.x * (per_block / 16);
  const int ntiles = per_block / 16 / TILE;
  auto load = [&](int t) {
    if (t >= ntiles) return;
    for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
      const uint32_t d = (uint32_t)__cvta_generic_to_shared(ring + (t % ST) * TILE + e);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(b + t * TILE + e));
    }
  };
  for (int t = 0; t < ST - 1; ++t) { load(t); asm volatile("cp.async.commit_group;\n"); }
  unsigned acc = 0;
  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    __syncthreads();
    load(t + ST - 1);
    asm volatile("cp.async.commit_group;\n");
    acc ^= ring[(t % ST) * TILE + threadIdx.x].x;
  }
  if (acc == 0x12345678u) sink[0] = acc;
}
extern "C" int stream_launch(void* src, void* sink, int blocks, int per_block, void* st) {
  const int smem = 4 * 1024 * 16;
  cudaFuncSetAttribute(stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stream<<<blocks, 256, smem, (cudaStream_t)st>>>((const uint4*)src, per_block, (unsigned*)sink);
  return (int)cudaGetLastError();
}
'''


def nvcc_shared(src: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    run = subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
                          "-fPIC", "-shared", "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


def patched_source() -> str:
    """ssd_chunk.cu with a `mark` call at each boundary of MARKS."""
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + PROF, 1)
    for kern, k, _, line, after in MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"mark {kern}:{k}: the line {line!r} is not in the "
                               "source exactly once")
        who = ", 128" if kern == 1 else ""
        call = f"  mark({kern}, {k.replace('jt', ' * jt')}{who});\n"
        src = src.replace(line, line + call if after else call + line)
    return src + EXTERN


def patched_library() -> ctypes.CDLL:
    src = patched_source()
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    (OUT / "ssd_chunk.cu").write_text(src)
    lib = nvcc_shared(OUT / "ssd_chunk.cu", OUT / "libphases.so")
    lib.ssd_chunk_fwd.argtypes = build._SIGNATURES["ssd_chunk_fwd"]
    lib.ssd_chunk_fwd.restype = ctypes.c_int
    lib.phases_set.argtypes = [ctypes.c_void_p] * 2
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def labels(kern: int) -> dict[int, str]:
    out = {}
    for kk, k, label, _, _ in MARKS:
        if kk != kern:
            continue
        if "jt" in k:
            first, stride = (int(v) for v in k.replace("jt", "").split("+"))
            for jt in range(4):
                out[first + stride * jt] = label.replace("jt", str(jt))
        else:
            out[int(k)] = label
    return out


def phases(lib, state: bool) -> None:
    b, s, h, g, n, p, chunk = cs.SSD_PATH.values()
    x, dt, a, bm, cm, st = cs.ssd_inputs(b, s, h, g, n, p, torch.bfloat16, 21)
    st = st if state else None
    bufs = [torch.zeros(1 << 20, dtype=torch.int64, device="cuda") for _ in range(2)]

    def call():
        k4.ssd(x, dt, a, bm, cm, chunk=chunk, state_in=st, return_state=True)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.phases_set(*(t.data_ptr() for t in bufs))
    call()
    torch.cuda.synchronize()
    lib.phases_set(None, None)
    marks = [t.view(-1, SLOTS).cpu().numpy().astype(np.float64) for t in bufs]
    marks = [m[m[:, 0] != 0] for m in marks]
    t0 = min(m[:, 0].min() for m in marks)
    for kern, (name, m) in enumerate(zip(("ssd_chunk_state_kernel",
                                          "ssd_chunk_scan_kernel"), marks)):
        since = {}
        for k, label in sorted(labels(kern).items()):
            live = m[:, k] != 0
            if live.any():
                since[label] = round(float(((m[live, k] - m[live, 0]) / 1e3).mean()), 3)
        print(json.dumps({"kernel": name, "state_in": state, "blocks": int(len(m)),
                          "first_start_us": float((m[:, 0].min() - t0) / 1e3),
                          "last_start_us": float((m[:, 0].max() - t0) / 1e3),
                          "last_mark_us": float((m[m != 0].max() - t0) / 1e3),
                          "mean_us_since_block_start": since}))


def yardstick() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "stream.cu").write_text(YARDSTICK)
    lib = nvcc_shared(OUT / "stream.cu", OUT / "libstream.so")
    lib.stream_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    per_block = 192 << 10
    src = torch.randint(0, 255, (128 * per_block,), dtype=torch.uint8, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    for blocks in (16, 128):
        us = 1e3 * cs.graph_ms(lambda blocks=blocks: lib.stream_launch(
            src.data_ptr(), sink.data_ptr(), blocks, per_block,
            torch.cuda.current_stream().cuda_stream), 20)
        print(json.dumps({"yardstick": "cp.async ring, 192 KB a block", "blocks": blocks,
                          "us": round(us, 3),
                          "GB_per_s_a_block": round(per_block / us / 1e3, 1),
                          "TB_per_s_in_all": round(blocks * per_block / us / 1e6, 3)}))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    loaded = build.load               # the built library (K1 bwd's o and lse)
    lib = patched_library()
    build.load = lambda: lib          # the wrappers launch the patched copy
    for state in (False, True):
        phases(lib, state)
    yardstick()
    lib_k1 = k1_patched_library()
    build.load = lambda: lib_k1
    k1_phases(lib_k1)
    build.load = loaded
    k1b_phases(k1b_patched_library())
    return 0


if __name__ == "__main__":
    sys.exit(main())
