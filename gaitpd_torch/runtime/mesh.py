"""Device meshes and batch sharding over ``torch.distributed``. Port of
gaitpd/runtime/mesh.py.

gaitpd's data parallelism is one SPMD program: the batch is sharded on its
leading axis, the parameters are replicated, and XLA inserts the gradient
sum. The port runs one process a rank (``torchrun``, or the spawned ranks of
gaitpd_torch/entry.py), each with the replicated parameters and its rows of
the global batch; the train step (gaitpd_torch/train/step.py) sums what
gaitpd's one program sums over the whole batch: the loss normalisers, the
per-task gradient matrix and the metrics (``BatchSharding.sum``).

    mesh = make_mesh()                      # the initialised group, or a 1-rank one
    rows = shard_batch(batch, mesh)         # this rank's contiguous rows
    mesh2 = make_mesh_2d(2)                 # ("slices", "data")
    rows = batch_sharding_2d(mesh2).rows(x)

Ranks run on the card (``cuda:LOCAL_RANK``, NCCL) unless the caller asks for
the CPU (gloo). A process group that is already initialised is used as it
is, whatever its backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gaitpd_torch.runtime.device import DeviceLike, resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_group(device: DeviceLike = None) -> torch.device:
    """Initialise the default process group if there is none, and return
    this rank's device: under ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ...) its group, ``cuda:LOCAL_RANK`` on the
    card; otherwise a group of one rank in this process."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(dev), init_method="env://", **kw)
        else:
            dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: DeviceLike = None) -> DeviceMesh:
    """A 1-D mesh over every rank of the process group (initialised by
    ``init_group`` when there is none). ``n_devices`` must be the group's
    size when given."""
    dev = init_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a group of {world} ranks")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


def make_mesh_2d(n_slices: int, per_slice: Optional[int] = None, dcn_axis: str = "slices",
                 ici_axis: str = "data", device: DeviceLike = None) -> DeviceMesh:
    """Two-level mesh: an outer axis over slices and an inner one within each
    slice. A batch sharded over both (``batch_sharding_2d``) is summed within
    a slice first, then across slices."""
    dev = init_group(device)
    world = dist.get_world_size()
    per_slice = per_slice or world // n_slices
    if n_slices * per_slice != world:
        raise ValueError(f"a {n_slices} x {per_slice} mesh over a group of {world} ranks")
    return init_device_mesh(dev.type, (n_slices, per_slice),
                            mesh_dim_names=(dcn_axis, ici_axis))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading axis split into contiguous blocks over the mesh axes
    ``dims`` (outer first); this rank holds block ``index`` of ``count``."""

    mesh: DeviceMesh
    dims: Tuple[str, ...]

    @property
    def count(self) -> int:
        n = 1
        for d in self.dims:
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(d))
        return n

    @property
    def index(self) -> int:
        i = 0
        for d in self.dims:
            i = i * self.mesh.size(self.mesh.mesh_dim_names.index(d)) + self.mesh.get_local_rank(d)
        return i

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``; a leading axis the mesh does not divide
        raises."""
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"batch_size must be divisible by the mesh size: {n} rows "
                             f"over {self.count}")
        b = n // self.count
        return x[self.index * b:(self.index + 1) * b]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the sharded ranks, the innermost axis first:
        within a slice, then across slices. Returns a new tensor."""
        out = t.detach().clone()
        for d in reversed(self.dims):
            if self.mesh.size(self.mesh.mesh_dim_names.index(d)) > 1:
                dist.all_reduce(out, group=self.mesh.get_group(d))
        return out


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data") -> BatchSharding:
    """Shard the leading (batch) axis over the mesh axis ``axis_name``."""
    return BatchSharding(mesh, (axis_name,))


def batch_sharding_2d(mesh: DeviceMesh) -> BatchSharding:
    """Shard the leading axis over both axes of a 2-D mesh."""
    return BatchSharding(mesh, tuple(mesh.mesh_dim_names))


def mesh_sharding(mesh: DeviceMesh) -> BatchSharding:
    """The batch sharded over every axis of ``mesh``."""
    return BatchSharding(mesh, tuple(mesh.mesh_dim_names))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def shard_batch(batch, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's rows of every tensor of a tree of batch tensors."""
    return _tree_map(batch_sharding(mesh, axis_name).rows, batch)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole value."""

    mesh: DeviceMesh


def replicated(mesh: DeviceMesh) -> Replicated:
    return Replicated(mesh)


def replicate(tree, mesh: DeviceMesh):
    """Broadcast every tensor of ``tree`` (a module's parameters and buffers,
    or a tree of tensors) from the mesh's first rank, in place; returns
    ``tree``."""
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else [])
    if not tensors:
        _tree_map(tensors.append, tree)
    if dist.get_world_size() > 1:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
    return tree


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def mesh_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's index over every axis of ``mesh`` (0 without one)."""
    return 0 if mesh is None else mesh_sharding(mesh).index


def mesh_size(mesh: Optional[DeviceMesh]) -> int:
    return 1 if mesh is None else mesh_sharding(mesh).count


@dataclasses.dataclass(frozen=True)
class FoldShard:
    """This rank's contiguous block ``[start, stop)`` of ``total`` stacked
    instances (folds, or (grid row, fold) pairs) and how to put the blocks'
    results back together; ``mesh`` None: one process holds them all."""

    mesh: Optional[DeviceMesh]
    start: int
    stop: int
    total: int

    def take(self, seq: Sequence) -> list:
        return list(seq[self.start:self.stop])

    def checkpoint_root(self, root):
        """Where this rank keeps its block's stacked checkpoint: ``root``
        itself in one process, else ``root/shard<i>of<n>``."""
        if root is None or self.mesh is None:
            return root
        per = self.stop - self.start
        return os.path.join(str(root), f"shard{self.start // per}of{self.total // per}")

    def gather(self, local: Sequence) -> List[Any]:
        """Every rank's ``local`` list (one entry an instance of its block),
        concatenated in instance order."""
        if self.mesh is None:
            return list(local)
        parts: List[Any] = [None] * mesh_size(self.mesh)
        dist.all_gather_object(parts, list(local))
        return [x for p in parts for x in p]


def shard_folds(n: int, mesh: Optional[DeviceMesh], tag: str = "[vmap-cv]",
                noun: str = "folds") -> FoldShard:
    """The block of ``n`` stacked instances this rank runs with its own
    generators and no collective in a step. When the mesh does not divide
    ``n``, it prints so and every rank runs all ``n``, as gaitpd runs them on
    one device."""
    size = mesh_size(mesh)
    if mesh is not None and n % size:
        print(f"{tag} {n} {noun} not divisible by {size} devices; running single-device")
        mesh = None
    if mesh is None:
        return FoldShard(None, 0, n, n)
    per = n // size
    r = mesh_rank(mesh)
    return FoldShard(mesh, r * per, (r + 1) * per, n)
