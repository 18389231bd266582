"""Multi-process runs on ``torch.distributed``.

Port of ``stlpose_tpu/parallel/distributed.py``: the process group's
bring-up, this process's place in it, the per-process slice of a dataset
and the gather of per-process numpy results onto every process. One
process drives one device (the PyTorch idiom), so a JAX mesh of W devices
is W ranks here.

The group comes from explicit arguments or from torchrun's environment
(``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``). With neither, every helper is the one-process identity,
so the engines call them unconditionally. A requested group that fails to
come up raises: a misconfigured multi-process run never carries on as a
single process.

``all_reduce_sum`` is the autograd-aware sum over a group (the gradient
of a sum over ranks is the sum of the ranks' gradients), which the
global BatchNorm statistics of ``models/hrnet.py::FlaxBatchNorm2d`` run
through.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables, any of which asks for a process group
ENV_KEYS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def default_backend() -> str:
    """``nccl`` where the ranks drive CUDA devices, ``gloo`` on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Bring up the default process group.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` names the group explicitly; otherwise torchrun's
    environment does, and with no such variable set this is a no-op.
    ``backend`` wins over ``default_backend()``; a failed bring-up is
    never retried on another backend. Raises ``RuntimeError`` when a
    requested group cannot be initialised."""
    if dist.is_initialized():
        return
    env_key = next((k for k in ENV_KEYS if k in os.environ), None)
    if coordinator_address is None and env_key is None:
        return
    backend = backend or default_backend()
    try:
        if coordinator_address is not None:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id)
        else:
            dist.init_process_group(backend, init_method="env://")
    except Exception as e:
        src = (f"coordinator_address={coordinator_address!r}"
               if coordinator_address is not None else f"env {env_key}")
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend!r}) failed for "
            f"an explicitly requested multi-process setup ({src}); refusing "
            "to silently fall back to single-process training") from e


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_slice(n_total: int) -> slice:
    """This process's contiguous share of ``n_total`` items."""
    per = (n_total + process_count() - 1) // process_count()
    start = process_index() * per
    return slice(start, min(start + per, n_total))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def all_gather_host(arrays, group=None):
    """Every process's numpy arrays (a dict, list or tuple of them, or one
    array), concatenated on axis 0 in rank order, on every process. The
    exchange is pickled host bytes, so it takes any backend and shapes
    that differ from rank to rank. One process: the identity."""
    if process_count() == 1:
        return arrays
    gathered = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, _tree_map(np.asarray, arrays),
                           group=group)
    leaves = [[] for _ in gathered]
    for r, tree in enumerate(gathered):
        _tree_map(leaves[r].append, tree)
    merged = iter([np.concatenate(parts) for parts in zip(*leaves)])
    return _tree_map(lambda _: next(merged), gathered[0])


def broadcast_host(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` (any picklable value) on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group=None) -> None:
    if process_count() > 1:
        dist.barrier(group=group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks, forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """``x`` summed over ``group``'s ranks, with the sum's gradient."""
    return _AllReduceSum.apply(x, group)
