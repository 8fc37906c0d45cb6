"""Production meshes (counterpart of ``repro/launch/mesh.py``): 16x16
single-pod, 2x16x16 multi-pod, over the current process group.

``make_production_mesh`` is a function, so importing this module touches
no process group; the dry run (``launch/dryrun.py``) first starts a
``"fake"`` group of 256 or 512 ranks in its one process.
"""
from __future__ import annotations


def _mesh(shape, names, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks, not "
            f"{dist.get_world_size() if dist.is_initialized() else 0}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device_type: str = "cpu"):
    """A small mesh for CPU tests (gloo ranks) or the card (one rank)."""
    if multi_pod:
        return _mesh((2, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
