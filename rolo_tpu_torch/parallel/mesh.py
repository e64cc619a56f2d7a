"""Process groups, device meshes and batch slices on `torch.distributed`: the
counterpart of `rolo_tpu/parallel/mesh.py`.

A JAX `Mesh` is a grid of devices driven by one program, and a sharded array
is one global value. Here every rank is a process with one device (gloo on
the CPU, NCCL on the card), a `torch.distributed.device_mesh.DeviceMesh`
arranges the ranks of the group in named axes, and a rank holds only its own
slice of a batch: `shard_batch` returns that slice where the reference
places a global array. Axis names follow the reference: ("batch",) for one
axis, ("host", "batch") for a pod, where "host" runs over groups of ranks.

`batch_sharding`, `replicated` and `pod_batch_sharding` return DTensor
placements (`Shard(0)` / `Replicate()` per mesh axis), the torch meaning of
a NamedSharding's PartitionSpec; nothing in the port distributes a DTensor,
they are there for callers who do. The reference's environment
auto-detection of a cluster has no torch counterpart beyond a launcher's
`WORLD_SIZE` / `RANK` / `MASTER_ADDR` variables (env://), which
`distributed_init` reads.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..runtime.platform import default_device


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group (mesh.py:85-113): `coordinator_address`
    "host:port" of rank 0's TCP store, `num_processes` ranks, this one
    `process_id`; or, with no arguments, a launcher's env:// variables when
    they name more than one rank. The backend defaults to NCCL when CUDA is
    available, else gloo. Returns True when the group spans more than one
    process; with no arguments in one process it does nothing and returns
    False. A group that already exists is kept."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if coordinator_address or num_processes:
            if coordinator_address is None or num_processes is None or process_id is None:
                raise ValueError("distributed_init needs coordinator_address, num_processes "
                                 "and process_id together")
            if backend == "nccl":
                torch.cuda.set_device(process_id % torch.cuda.device_count())
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id)
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://")
    return dist.is_initialized() and dist.get_world_size() > 1


def _ensure_group(device_type: str) -> None:
    """A one-rank group on an in-process store when none exists, so a mesh
    of one device works without a launcher."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    if dist.is_initialized():
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return default_device().type


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("batch",),
              axis_sizes: Optional[Sequence[int]] = None, device_type: Optional[str] = None):
    """A DeviceMesh over the group's ranks (mesh.py:26-44). One axis spans
    all `n_devices`; several need `axis_sizes` multiplying to it. The mesh
    covers the whole group, so `n_devices` must equal its size."""
    device_type = _device_type(device_type)
    _ensure_group(device_type)
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"a mesh spans the whole group: {n_devices} devices asked, "
                         f"{world} ranks")
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        axis_sizes = (n_devices,)
    if math.prod(axis_sizes) != n_devices:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} do not multiply to {n_devices}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def make_pod_mesh(n_hosts: Optional[int] = None, devices_per_host: Optional[int] = None,
                  axis_names: Sequence[str] = ("host", "batch"),
                  device_type: Optional[str] = None):
    """A 2-D ("host", "batch") mesh (mesh.py:116-131): `n_hosts` groups of
    `devices_per_host` ranks. One rank has one device, so by default every
    process is a host of one device."""
    device_type = _device_type(device_type)
    _ensure_group(device_type)
    world = dist.get_world_size()
    devices_per_host = 1 if devices_per_host is None else devices_per_host
    n_hosts = world // devices_per_host if n_hosts is None else n_hosts
    return make_mesh(n_hosts * devices_per_host, axis_names, (n_hosts, devices_per_host),
                     device_type)


def axis_size(mesh, axis_name) -> int:
    """Ranks along one mesh axis, or along several (a tuple) together."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(nm)) for nm in names)


def axis_index(mesh, axis_name) -> int:
    """This rank's index along the axes, the first axis major."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    coord = mesh.get_coordinate()
    index = 0
    for nm in names:
        dim = mesh.mesh_dim_names.index(nm)
        index = index * mesh.size(dim) + coord[dim]
    return index


def _placements(mesh, sharded: Sequence[str]) -> Tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if nm in sharded else Replicate() for nm in mesh.mesh_dim_names)


def batch_sharding(mesh, axis_name: str = "batch") -> Tuple:
    """DTensor placements splitting axis 0 over `axis_name` (P(axis_name))."""
    return _placements(mesh, (axis_name,))


def replicated(mesh) -> Tuple:
    return _placements(mesh, ())


def pod_batch_sharding(mesh) -> Tuple:
    """Axis 0 split over every mesh axis, the first major (P(("host", "batch")))."""
    return _placements(mesh, mesh.mesh_dim_names)


def _map_leaves(fn, tree):
    if isinstance(tree, tuple):
        items = [_map_leaves(fn, item) for item in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [_map_leaves(fn, item) for item in tree]
    if isinstance(tree, dict):
        return {key: _map_leaves(fn, value) for key, value in tree.items()}
    return fn(tree)


def shard_batch(pytree, mesh, axis_name="batch"):
    """This rank's slice of axis 0 of every leaf over `axis_name` (one axis
    or a tuple of axes, mesh.py:56-73): leaves whose leading dimension the
    axis size does not divide, and non-tensors, are replicated (returned
    whole)."""
    size, index = axis_size(mesh, axis_name), axis_index(mesh, axis_name)

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] > 0 \
                and x.shape[0] % size == 0:
            step = x.shape[0] // size
            return x[index * step:(index + 1) * step]
        return x

    return _map_leaves(place, pytree)


def shard_batch_pod(pytree, mesh):
    """shard_batch over every axis of a pod mesh (mesh.py:140-153)."""
    return shard_batch(pytree, mesh, tuple(mesh.mesh_dim_names))


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (batch padding for even slices)."""
    return ((n + m - 1) // m) * m
