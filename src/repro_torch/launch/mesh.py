"""Production and small meshes as ``torch.distributed`` device meshes.

Defined as functions (never module-level constants): importing this module
touches no process group and no device.  A mesh needs an initialised
process group: one made by the caller, else one from ``torchrun``'s
environment (nccl for CUDA meshes, gloo for CPU ones), else a one-process
group, and that only for a mesh of one device.  The sharding policy reads mesh
*shapes*, so :func:`production_mesh_shape` serves the dry-run without 256
devices.
"""

from __future__ import annotations

import math
import os

__all__ = ["make_production_mesh", "make_small_mesh", "production_mesh_shape"]


def production_mesh_shape(*, multi_pod: bool = False) -> dict[str, int]:
    """16×16 = 256 chips a pod; multi-pod adds the 2-pod axis (512 chips)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def _mesh(sizes: dict[str, int], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(sizes.values())
    n = math.prod(shape)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"need {n} devices for mesh {shape}; have 1 (no process "
                "group: run one process a device, e.g. under torchrun)")
        # one process, one device: a group with nothing to talk to
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}; have {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh on ``device_type`` devices (one process each)."""
    return _mesh(production_mesh_shape(multi_pod=multi_pod), device_type)


def make_small_mesh(data: int = 2, model: int = 2, pod: int | None = None, *,
                    device_type: str = "cuda"):
    """Reduced mesh for tests and examples (``data·model·(pod or 1)``
    processes); ``device_type="cpu"`` puts it on the CPU (gloo)."""
    sizes = {"pod": pod} if pod else {}
    sizes.update(data=data, model=model)
    return _mesh(sizes, device_type)
