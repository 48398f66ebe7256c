"""Mesh construction (port of ``repro/launch/mesh.py``): functions only —
importing this module sets up no process group and no environment
variable.

A :class:`~torch.distributed.device_mesh.DeviceMesh` spans the ranks of
the default process group, one process per card; the axis names and
shapes are the JAX package's:

  single-pod : (data=16, model=16)         — 256 chips
  multi-pod  : (pod=2, data=16, model=16)  — 512 chips

'pod' is pure data parallelism (gradient all-reduce across pods),
'data' is FSDP, 'model' is tensor/expert parallelism.

:func:`fake_world` is the counterpart of JAX's
``--xla_force_host_platform_device_count``: an n-rank world with no
device behind it (PyTorch's fake backend), where the production meshes
can be built and tensors distributed to read their local shapes.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group's
    ranks (their count must be the shape's product)."""
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The target deployment mesh: (data=16, model=16), or (pod=2,
    data=16, model=16) multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) mesh over the world that exists: the default
    process group's ranks (one process per card, as ``torchrun`` starts
    them), or, where none is set up, a world of this one process — (1, 1)
    on one H100 (NCCL) or on the CPU (gloo), over an in-process store."""
    dt = _device_type(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dt == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    model = max(1, min(model, n))
    return make_mesh((n // model, model), ("data", "model"), dt)


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """An ``n``-rank default process group with no device behind it (this
    process is rank 0; collectives return at once and move nothing), for
    building the production meshes and reading local shapes. The group is
    destroyed on exit; no other group may exist meanwhile."""
    # PyTorch's fake backend lives in its testing package; this is the
    # one place the port reaches it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists: fake_world "
                           "needs the default group for itself")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
