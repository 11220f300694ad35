#!/usr/bin/env python3
"""Where K4's bf16 kernels spend their time, block by block, on the card.

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
and in all.  Prints the card's name and power limit first.
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
    (0, "2", "cums scanned", "  const float last = cums[QP - 1];\n", True),
    (0, "3", "w computed", "  if (tid == 0) ws_last[(size_t)bh * nc + c] = last;"
     "   // each P tile's carry reads it\n", True),
    (0, "4+2jt", "tile jt in shared memory",
     "tile jt (and w) for every thread; tile jt-1's readers done\n", True),
    (0, "5+2jt", "tile jt's products done",
     "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(acc);\n  }\n"
     "  // S^ through shared memory", False),
    (0, "20", "S^ stored", "  // the carry, by the last block", False),
    (0, "21", "last ticket drawn (carry blocks)",
     "  if (!__syncthreads_or(tid == 0 && ticket == (unsigned)nc - 1)) return;\n", True),
    (0, "23", "carry: chunks walked", "  if (state_out != nullptr) {\n#pragma unroll\n"
     "    for (int k = 0; k < GPT; ++k) {\n      const int g", False),
    (0, "22", "carry done", "  if (tid == 0) *counter = 0u;\n", True),
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
    lib = patched_library()
    build.load = lambda: lib          # the wrapper launches the patched copy
    for state in (False, True):
        phases(lib, state)
    yardstick()
    return 0


if __name__ == "__main__":
    sys.exit(main())
