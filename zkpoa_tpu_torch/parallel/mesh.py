"""Multi-GPU sharding on torch.distributed: process groups, device meshes
and the sharded MSMs.

Port of `zkpoa_tpu/parallel/mesh.py`. The JAX package runs one process that
drives every device, with global arrays placed on a `jax.sharding.Mesh`.
The port follows PyTorch's idiom instead: one process per card (as
`torchrun --nproc-per-node k` starts them), each holding the inputs in
full. A function takes its rank's share, and returns the whole result on
every rank. The axes keep their meaning:

  * batch axis ("batch"): independent proof batches (layer-1/2 chains), the
    reference's `parallel prove_layers_one_two`, one block a rank;
  * data axis ("data"): within one proof, MSM points and NTT rows sharded
    across ranks.

MSM combine: each rank runs the port's MSM (`ops/msm.py`) over its block of
points and scalars; the MSM decodes to a host affine point, so the ranks'
partial sums are combined as group elements, gathered with
`all_gather_object` and added by a log-depth tree of host adds.

The backend follows the device: NCCL for `cuda` (one card a rank,
`torch.cuda.set_device(local_rank)`), gloo for `cpu`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops import msm as M


def _device_type(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def world_size() -> int:
    """Ranks of the default process group (1 when none is up)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device="cuda") -> int:
    """Start the default process group: from the arguments, or from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK). A no-op for a single process and when a group is already
    up. `coordinator_address` is an init method (`tcp://host:port`,
    `file:///path`) or a bare `host:port`. On `cuda` each rank takes card
    LOCAL_RANK (else rank mod the cards). Returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return 1
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if _device_type(device) == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return world


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device="cuda") -> DeviceMesh:
    """A 1-D mesh over ranks 0 .. n-1 (all ranks by default), as
    `jax.devices()[:n]`. Every rank calls it; a rank past n is outside the
    mesh (`get_coordinate()` is None)."""
    n = world_size() if n_devices is None else n_devices
    return DeviceMesh(_device_type(device), torch.arange(n), mesh_dim_names=(axis,))


def make_hierarchical_mesh(dcn_axis: str = "batch", ici_axis: str = "data",
                           shape: Optional[Tuple[int, int]] = None,
                           device="cuda") -> DeviceMesh:
    """2-D mesh (hosts x local ranks): the outer axis for independent
    proof batches (rare collectives), the inner for intra-proof sharding.
    The default shape is (world / LOCAL_WORLD_SIZE, LOCAL_WORLD_SIZE);
    `shape` overrides it, e.g. (2, 2) simulates two hosts on four
    processes."""
    world = world_size()
    if shape is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        shape = (world // local, local)
    assert shape[0] * shape[1] == world, (shape, world)
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=(dcn_axis, ici_axis))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _block(n: int, mesh: DeviceMesh, axis: str) -> slice:
    d = axis_size(mesh, axis)
    assert n % d == 0, f"leading dim {n} must divide into the {d} ranks of axis {axis!r}"
    i, per = mesh.get_local_rank(axis), n // d
    return slice(i * per, (i + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_leading(arr_tree, mesh: DeviceMesh, axis: str = "data"):
    """This rank's block of the leading dim of every tensor in the tree
    (the dim must divide into the axis's ranks)."""
    return _tree_map(lambda a: a[_block(a.shape[0], mesh, axis)], arr_tree)


def replicate(arr_tree, mesh: DeviceMesh):
    """Every tensor of the tree as the mesh's first rank holds it: a
    broadcast along each mesh dim from its first rank, last dim first."""
    def put(a):
        t = a.clone().contiguous()
        for dim in reversed(range(mesh.ndim)):
            g = mesh.get_group(dim)
            dist.broadcast(t, src=dist.get_global_rank(g, 0), group=g)
        return t

    return _tree_map(put, arr_tree)


def _sliced(table, sl: slice):
    return type(table)(table.xs[sl], table.ys[sl], table.valid[sl])


def tree_sum(curve, points: List):
    """The log-depth tree of `mesh.py:68-84` over host points of the curve
    (None is infinity): pairs i, i + m/2 added, an odd tail added to the
    first."""
    reduced, m = list(points), len(points)
    while m > 1:
        half = m // 2
        summed = [curve.host_add(reduced[i], reduced[half + i]) for i in range(half)]
        if m % 2:
            summed[0] = curve.host_add(summed[0], reduced[m - 1])
        reduced, m = summed, half
    return reduced[0]


def gather_objects(obj, group=None) -> List:
    """all_gather_object over `group` (the world by default)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def msm_sharded(curve, table, scalars: torch.Tensor, mesh: DeviceMesh, c: Optional[int] = None,
                axis: str = "data"):
    """MSM with the table's points and the scalars [N, 8] (plain limbs)
    sharded along `axis`: this rank's block through `ops/msm.py` `msm`,
    then the ranks' partial sums combined as group elements. Returns the
    same host affine point (None = infinity) on every rank as the
    one-device MSM. N must divide into the axis's ranks (pad upstream with
    rows whose `valid` is False)."""
    sl = _block(scalars.shape[0], mesh, axis)
    part = M.msm(curve, _sliced(table, sl), scalars[sl].contiguous(), c)
    return tree_sum(curve, gather_objects(part, mesh.get_group(axis)))


def msm_batch_sharded(curve, table, scalars_nb: torch.Tensor, mesh: DeviceMesh,
                      c: Optional[int] = None, batch_axis: str = "batch",
                      data_axis: str = "data") -> List:
    """Hierarchical MSM over a 2-D mesh: the batches [NB, N, 8] over
    `batch_axis`, each batch's points sharded over `data_axis`. Partial
    sums cross only the data axis's group; the finished batch sums are
    then gathered over the batch axis. Returns NB host points on every
    rank."""
    bsl = _block(scalars_nb.shape[0], mesh, batch_axis)
    dsl = _block(scalars_nb.shape[1], mesh, data_axis)
    local = _sliced(table, dsl)
    plans = [M.plan_msm(sc[dsl].contiguous(), c, split_heavy=False) for sc in scalars_nb[bsl]]
    parts = M.msm_many(curve, [(local, p, 0) for p in plans])
    gathered = gather_objects(parts, mesh.get_group(data_axis))
    sums = [tree_sum(curve, [g[b] for g in gathered]) for b in range(len(parts))]
    return [pt for block in gather_objects(sums, mesh.get_group(batch_axis)) for pt in block]
