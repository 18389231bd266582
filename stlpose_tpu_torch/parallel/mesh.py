"""The data-parallel mesh and the per-rank batch.

Port of ``stlpose_tpu/parallel/mesh.py``. A JAX mesh of W devices is W
ranks of the default process group, one device each: ``get_mesh`` returns
a 1-D ``DeviceMesh`` named ("data",) over the world, or, with no process
group, ``LocalMesh``, one rank on the caller's device. A batch sharded
over the data axis is, on rank r, rows ``[r*B/W, (r+1)*B/W)`` of the
global batch, the order of ``jax.sharding``'s data axis;
``shard_batch`` uploads only those rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.parallel.distributed import initialize_distributed

DATA_AXIS = "data"


class LocalMesh:
    """A one-rank mesh with no process group (the one-process run)."""

    mesh_dim_names = (DATA_AXIS,)

    def __init__(self, device_type: str):
        self.device_type = device_type

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None


def get_mesh(n_devices: int | None = None, device="cuda"):
    """The data-parallel mesh over every rank.

    Brings the process group up from torchrun's environment first
    (``initialize_distributed``), so a script launched with ``torchrun
    --nproc-per-node N`` shards with no change. ``device`` is this rank's
    device (a bare "cuda" under torchrun is ``cuda:{LOCAL_RANK}``); a CUDA
    device becomes the current one. ``n_devices`` is the world's size, or
    1 for a ``LocalMesh`` on every rank."""
    initialize_distributed()
    dev = resolve_device(device)
    if not dist.is_initialized() or n_devices == 1:
        return LocalMesh(dev.type)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"get_mesh({n_devices}) on a world of {world} "
                         "ranks: the mesh spans the world or one rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=(DATA_AXIS,))


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank()


def mesh_group(mesh):
    """The mesh's process group, None for a one-rank mesh."""
    return None if mesh_size(mesh) == 1 else mesh.get_group()


def local_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``; ``n`` must divide by
    the mesh."""
    w = mesh_size(mesh)
    if n % w:
        raise ValueError(f"a batch of {n} does not divide over {w} ranks; "
                         "pad it to a multiple (pad_to_multiple)")
    per = n // w
    r = mesh_rank(mesh)
    return slice(r * per, (r + 1) * per)


def _shard_leaf(mesh, x, device):
    if isinstance(x, torch.Tensor):
        return x[local_rows(mesh, x.shape[0])].to(device)
    if isinstance(x, np.ndarray) and x.ndim:
        return torch.from_numpy(
            np.ascontiguousarray(x[local_rows(mesh, x.shape[0])])).to(device)
    return x


def shard_batch(mesh, batch, device):
    """This rank's rows of every array or tensor in ``batch`` (a dict,
    list or tuple of them, or one), uploaded to ``device``; scalars pass
    through. The leading axis must divide by the mesh (the pipelines pad
    their last batch to a multiple)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, device) for v in batch)
    return _shard_leaf(mesh, batch, device)


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Pad an array's axis up to a multiple with its last entry repeated;
    returns (array, n_valid)."""
    n = array.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, rem)
    return np.pad(array, pad, mode="edge"), n
