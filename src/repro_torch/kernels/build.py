"""Build the Hopper kernels from ``csrc/`` at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c`` (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with plain ``extern "C"`` entry points.  The library lands in
``build/kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  Nothing here runs at
import time: the first kernel launch builds, and a process without ``nvcc``
fails there, with the reason.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

__all__ = ["BuildResult", "build", "load", "check", "counters"]

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# no fast-math flag: the int8 kernels must divide and round exactly as IEEE,
# and keep subnormal inputs (no flush to zero)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libreprotorch_kernels.so"

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_LONG = ctypes.c_longlong
# entry point -> argtypes; every pointer and the stream are c_void_p
_SIGNATURES = {
    "flash_attention_fwd": [_VOID] * 5 + [_INT] * 9 + [_FLOAT, _FLOAT, _VOID],
    "flash_attention_bwd": [_VOID] * 12 + [_INT] * 11 + [_FLOAT, _FLOAT, _VOID],
    "quantize_int8_fwd": [_VOID] * 3 + [_INT] * 3 + [_VOID],
    "dequantize_int8_fwd": [_VOID] * 3 + [_INT] * 3 + [_VOID],
    "decode_attention_fwd": [_VOID] * 4 + [_INT] + [_VOID] * 4 + [_INT] * 10
    + [_FLOAT, _FLOAT, _VOID],
    "ssd_chunk_fwd": [_VOID] * 14 + [_INT] * 8 + [_LONG] * 6 + [_VOID],
    "ssd_chunk_bwd": [_VOID] * 27 + [_INT] * 8 + [_LONG] * 6 + [_VOID],
    "rglru_fwd": [_VOID] * 5 + [_INT] * 4 + [_VOID],
    "rglru_bwd": [_VOID] * 8 + [_INT] * 3 + [_VOID],
    "rglru_chunk_steps": [],
}


@dataclass(frozen=True)
class BuildResult:
    path: pathlib.Path
    seconds: float        # 0.0 when the library was already built
    log: str              # nvcc / ptxas output (registers, spills, smem)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels are built from "
                       "csrc/ with the CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH + CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile and link the kernels unless this source hash is built."""
    out = BUILD_ROOT / _digest() / LIB_NAME
    if out.exists():
        return BuildResult(out, 0.0, "")
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in _sources()]
        procs = [
            subprocess.Popen([nvcc, *ARCH, *CFLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(_sources(), objs)
        ]
        logs, failed = [], []
        for src, proc in zip(_sources(), procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = pathlib.Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out)  # atomic: a concurrent builder sees all or nothing
    return BuildResult(out, time.perf_counter() - t0, "\n".join(logs))


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (0 is success)."""
    if err != 0:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_COUNTERS: dict = {}


def counters(owner: str, device, n: int):
    """Zeroed int32 ticket counters of one kernel family on one card, at
    least ``n``, allocated once.  The kernels leave them at 0, so calls of
    one family on one card must be ordered on one stream."""
    import torch

    buf = _COUNTERS.get((owner, device))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[(owner, device)] = buf
    return buf
