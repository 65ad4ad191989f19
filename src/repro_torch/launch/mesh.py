"""Meshes of processes: the port of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the JAX package's
axis names (``distributed.sharding.Mesh``) over the ranks of the default
process group, one rank per device: NCCL on ``cuda`` (rank r takes card
``LOCAL_RANK``), gloo on ``cpu``. ``init_distributed`` joins the group a
launcher set up (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or starts a world of one process;
``spawn_cpu_ranks`` starts N gloo ranks on this host, the counterpart of
the JAX package's forced host devices (``--devices N``). Single pod:
("data", "model"); multi-pod: ("pod", "data", "model"), the pod axis
folding into data parallelism. Functions, not module constants: importing
never touches the process group.
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import Mesh
from repro_torch.models.params import resolve_device

#: a collective that waits this long fails instead of hanging the run
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(device="cuda", timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the default process group, or start one: from the
    ``torchrun`` environment when ``WORLD_SIZE`` is set, else a world of
    one process (an in-memory store). NCCL for ``cuda`` (this rank on card
    ``LOCAL_RANK``), gloo for ``cpu``. Returns True when this call started
    the group (the caller then ends it with ``dist.destroy_process_group``)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` over the process group's ranks (their number
    must be the shape's product)."""
    from torch.distributed.device_mesh import init_device_mesh
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks, the group "
                         f"has {dist.get_world_size()}")
    return Mesh(init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes)))


def production_mesh_shape(n: int, multi_pod: bool = False):
    """(shape, axes) of the production mesh over ``n`` ranks: 16 x 16, or
    2 x 16 x 16 with ``multi_pod``, shrunk as the JAX package shrinks it
    when fewer ranks exist ((2, n // 2) or (2, 2, 2)), keeping the axis
    structure so the rules are exercised the same way."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if n < math.prod(shape):
        shape = (2, 2, 2) if multi_pod else (2, n // 2)
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    n = dist.get_world_size()
    shape, axes = production_mesh_shape(n, multi_pod)
    if (shape, axes) != production_mesh_shape(10**9, multi_pod):
        print(f"[mesh] only {n} devices — using reduced test mesh {shape} {axes}")
    return make_test_mesh(shape, axes)


def cli_mesh_shape(kind: str, n: int):
    """(shape, axes) of the CLI's mesh ``kind`` over ``n`` ranks: ``auto``
    data-parallels over every rank ((n, 1); one rank is a degenerate (1, 1)
    mesh and the sharded step is still the step), ``test`` is (2, n / 2),
    ``single``/``multi`` the production meshes."""
    if kind == "auto":
        return (n, 1), ("data", "model")
    if kind == "test":
        if n < 2:
            raise ValueError("--mesh test needs >= 2 ranks (--devices N with --device cpu, "
                             "or torchrun --nproc-per-node N)")
        return (2, n // 2), ("data", "model")
    if kind not in ("single", "multi"):
        raise ValueError(f"unknown mesh kind {kind!r}")
    need = 8 if kind == "multi" else 2
    if n < need:
        raise ValueError(f"--mesh {kind} needs >= {need} ranks")
    return production_mesh_shape(n, multi_pod=kind == "multi")


def make_cli_mesh(kind: str) -> Mesh:
    """The train launcher's mesh (``cli_mesh_shape``) over the group."""
    if kind in ("single", "multi"):
        cli_mesh_shape(kind, dist.get_world_size())       # the rank count's check
        return make_production_mesh(multi_pod=kind == "multi")
    return make_test_mesh(*cli_mesh_shape(kind, dist.get_world_size()))


def _rank_main(rank, world, store, timeout, fn, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timeout)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_ranks(n: int, fn, args=(), timeout: datetime.timedelta = TIMEOUT) -> None:
    """Run ``fn(*args)`` in ``n`` new processes, a gloo group of ``n``
    ranks on this host (rendezvous through a file store in a fresh
    temporary directory); returns when every rank has, raises when one
    failed."""
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as d:
        mp.spawn(_rank_main, args=(n, os.path.join(d, "store"), timeout, fn, args), nprocs=n,
                 join=True)
