"""The port's multi-process plumbing (stlpose_tpu_torch/parallel/
distributed.py and mesh.py), as tests/test_distributed.py holds the JAX
package's: a real 2-process gloo run of ``initialize_distributed``, the
process helpers, ``all_gather_host``, ``get_mesh`` and ``shard_batch``;
the loud failure of an explicitly requested group that does not come
up; the no-op without one; and the device rule under torchrun."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.parallel import distributed
from stlpose_tpu_torch.parallel.mesh import (LocalMesh, get_mesh,
                                             local_rows, pad_to_multiple,
                                             shard_batch)
from tests.torch_ranks import launch, results
import tests.torch_threads  # noqa: F401  (caps torch's threads)

_BODY = """
from stlpose_tpu_torch.parallel.distributed import (
    all_gather_host, all_reduce_sum, barrier, broadcast_host, host_slice,
    process_count, process_index)
from stlpose_tpu_torch.parallel.mesh import get_mesh, shard_batch
import torch.distributed as dist

sl = host_slice(10)
gathered = all_gather_host({"preds": np.full((3, 2), rank, np.float32),
                            "ids": [np.arange(rank + 1)]})
mesh = get_mesh(device="cpu")
batch = {"image": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
         "n_valid": 7, "ids": torch.arange(8)}
local = shard_batch(mesh, batch, "cpu")
x = torch.full((3,), float(rank + 1), requires_grad=True)
y = all_reduce_sum(x, None)
(y * (rank + 1)).sum().backward()
barrier()
save({"count": process_count(), "index": process_index(),
      "backend": dist.get_backend(), "slice": (sl.start, sl.stop),
      "gathered": gathered, "mesh": (type(mesh).__name__, mesh.size(),
                                     mesh.mesh_dim_names,
                                     mesh.get_local_rank()),
      "local": local, "reduced": y.detach(), "grad": x.grad,
      "broadcast": broadcast_host(f"from {rank}")})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ws = tmp_path_factory.mktemp("distributed")
    launch(ws, _BODY, timeout=120)
    return results(ws)


def test_two_process_initialize_and_allgather(ranks):
    for r, res in enumerate(ranks):
        assert (res["count"], res["index"], res["backend"]) == (2, r, "gloo")
        assert res["slice"] == (5 * r, 5 * (r + 1))
        g = res["gathered"]
        assert g["preds"].shape == (6, 2) and g["preds"].sum() == 6.0
        np.testing.assert_array_equal(g["preds"][:, 0], [0, 0, 0, 1, 1, 1])
        np.testing.assert_array_equal(g["ids"][0], [0, 0, 1])
        assert res["broadcast"] == "from 0"


def test_two_process_mesh_and_shard_batch(ranks):
    """A 1-D DeviceMesh named ("data",) over both ranks; rank r holds rows
    [4r, 4r + 4) of every array and tensor; scalars pass through."""
    for r, res in enumerate(ranks):
        assert res["mesh"] == ("DeviceMesh", 2, ("data",), r)
        local = res["local"]
        np.testing.assert_array_equal(
            local["image"].numpy(),
            np.arange(24, dtype=np.float32).reshape(8, 3)[4 * r:4 * r + 4])
        assert local["ids"].tolist() == list(range(4 * r, 4 * r + 4))
        assert local["n_valid"] == 7


def test_all_reduce_sum_sums_values_and_gradients(ranks):
    """y = x_0 + x_1 on both ranks; rank r's loss (r + 1) * sum(y), so
    each x's gradient is the sum of both ranks' weights."""
    for res in ranks:
        assert res["reduced"].tolist() == [3.0] * 3
        assert res["grad"].tolist() == [3.0] * 3


def test_explicit_coordinator_failure_raises(monkeypatch):
    def boom(*a, **k):
        raise ConnectionError("no coordinator there")

    monkeypatch.setattr(dist, "init_process_group", boom)
    for k in distributed.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="refusing to silently"):
        distributed.initialize_distributed("127.0.0.1:1", 2, 0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="refusing to silently"):
        distributed.initialize_distributed()


def test_no_coordinator_is_noop(monkeypatch):
    def boom(*a, **k):  # must never be called
        raise AssertionError("init_process_group called without a group")

    monkeypatch.setattr(dist, "init_process_group", boom)
    for k in distributed.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    distributed.initialize_distributed()
    assert not dist.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.host_slice(10) == slice(0, 10)
    arrays = {"a": np.ones((2, 3))}
    assert distributed.all_gather_host(arrays) is arrays


def test_backend_choice(monkeypatch):
    """gloo on a CPU-only machine, an explicit backend first, and the
    backend that failed is the one reported (no switch after it)."""
    calls = []

    def record(backend, **kw):
        calls.append((backend, kw))
        raise ConnectionError("refused")

    monkeypatch.setattr(dist, "init_process_group", record)
    assert distributed.default_backend() == "gloo"
    for backend, want in ((None, "gloo"), ("nccl", "nccl")):
        with pytest.raises(RuntimeError, match=f"'{want}'"):
            distributed.initialize_distributed("127.0.0.1:1", 2, 1,
                                               backend=backend)
    assert [c[0] for c in calls] == ["gloo", "nccl"]
    assert calls[0][1] == {"init_method": "tcp://127.0.0.1:1",
                           "world_size": 2, "rank": 1}


def test_one_process_mesh_and_batch(monkeypatch):
    """Without a process group: a one-rank LocalMesh, the whole batch
    uploaded, pad_to_multiple as the reference's."""
    for k in distributed.ENV_KEYS + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    mesh = get_mesh(device="cpu")
    assert isinstance(mesh, LocalMesh)
    assert (mesh.size(), mesh.get_local_rank(), mesh.get_group()) == \
        (1, 0, None)
    out = shard_batch(mesh, [np.arange(6), 3], torch.device("cpu"))
    assert out[0].tolist() == list(range(6)) and out[1] == 3
    with pytest.raises(ValueError, match="divide"):
        local_rows(_FakeMesh(), 5)
    a, n = pad_to_multiple(np.arange(5)[:, None], 4)
    assert n == 5 and a[:, 0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    a, n = pad_to_multiple(np.arange(4), 4)
    assert n == 4 and a.tolist() == [0, 1, 2, 3]


class _FakeMesh:
    def size(self):
        return 2

    def get_local_rank(self):
        return 1


def test_cuda_under_torchrun_is_the_local_rank_card(monkeypatch):
    """"cuda" under LOCAL_RANK names cuda:{LOCAL_RANK} and raises when no
    such card exists (none here); "cpu" is unaffected."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1 names cuda:1"):
        resolve_device("cuda")
    for k in distributed.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="cuda:1"):
        get_mesh(device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
