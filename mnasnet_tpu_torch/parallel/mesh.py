"""The ranks of a run laid out as a ``dcn × data × spatial`` mesh.

Counterpart of ``mnasnet_tpu/parallel/mesh.py``. The reference builds a
``('data', 'spatial')`` device mesh, or ``('dcn', 'data', 'spatial')`` with
``make_mesh(dcn=N)``, shards a global NHWC batch with N over ``data`` (and
``dcn``) and H over ``spatial`` (``batch_sharding``), and lets GSPMD insert
the collectives, the halo exchanges of the k > 1 convs among them. Here
each rank is one process of the default group, and the mesh says which
part of the global batch it holds:

  * ranks are laid out slice-major, ``rank = (i_dcn·data + i_data)·spatial +
    i_spatial``: the ``spatial`` consecutive ranks of one *spatial group*
    hold the same images, each its band of rows; the ``dcn × data`` groups
    (:attr:`Mesh.data_shards`) hold disjoint samples (:meth:`Mesh.data_index`);
  * the world-wide collectives (sync-BN's sums, the gradients, the metrics)
    stay over the whole world: the bands partition the rows of every plane,
    so a sum over all ranks is the sum over the global batch;
  * the halo exchanges and the pooled features are summed within a spatial
    group, over a process subgroup (:func:`use_mesh` makes them, every rank
    every group, in the same order, before any step).

A ``dcn`` axis changes no collective: the batch shards over ``dcn × data``
jointly and every reduction is world-wide, which is the reduction over all
shards the reference's hierarchical one computes. ``make_mesh(world,
dcn=2)`` therefore gives the flat data mesh's step bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from mnasnet_tpu_torch.parallel.spatial import bands


class Mesh(NamedTuple):
    """A ``dcn × data × spatial`` layout of ``dcn·data·spatial`` ranks."""

    dcn: int
    data: int
    spatial: int

    @property
    def world(self) -> int:
        return self.dcn * self.data * self.spatial

    @property
    def data_shards(self) -> int:
        """The number of disjoint shards of the batch: ``dcn·data``."""
        return self.dcn * self.data

    def data_index(self, rank: int) -> int:
        """The shard of the batch that ``rank`` holds (N over ``dcn × data``):
        ``i_dcn·data + i_data``."""
        return rank // self.spatial

    def spatial_index(self, rank: int) -> int:
        """The band of rows that ``rank`` holds (H over ``spatial``)."""
        return rank % self.spatial


def make_mesh(world: int, data: Optional[int] = None, spatial: int = 1, dcn: int = 1) -> Mesh:
    """The mesh of ``world`` ranks (``make_mesh``, ``mesh.py:31-49``): ``data``
    defaults to ``world // (spatial·dcn)``; raises unless the axes multiply to
    ``world``."""
    for name, size in (("spatial", spatial), ("dcn", dcn)):
        if size < 1:
            raise ValueError(f"mesh axis {name}={size} must be >= 1")
    if data is None:
        data = world // (spatial * dcn)
    if data < 1 or dcn * data * spatial != world:
        raise ValueError(f"mesh {dcn}x{data}x{spatial} != {world} devices")
    return Mesh(dcn, data, spatial)


def use_mesh(replicas, mesh: Mesh) -> None:
    """Lay ``replicas`` out as ``mesh``: make every spatial group's process
    subgroup (a collective call of every rank, in the same order) and keep
    this rank's. Call it on every rank before the first step, and before any
    CUDA graph captures one."""
    if mesh.world != replicas.world:
        raise ValueError(f"mesh {mesh.dcn}x{mesh.data}x{mesh.spatial} != {replicas.world} "
                         "devices")
    group = None
    if mesh.spatial > 1:
        for first in range(0, mesh.world, mesh.spatial):
            ranks = list(range(first, first + mesh.spatial))
            made = dist.new_group(ranks)
            if replicas.rank in ranks:
                group = made
    replicas.mesh = mesh
    replicas.spatial_group = group
    replicas.spatial_counts = {}
    replicas.spatial_planes = {}


def spatial_of(replicas) -> Optional[Mesh]:
    """The mesh of ``replicas`` when it splits rows over ranks, else None."""
    mesh = getattr(replicas, "mesh", None) if replicas is not None else None
    return mesh if mesh is not None and mesh.spatial > 1 else None


def data_layout(replicas) -> tuple[int, int]:
    """(shard index, shards) of the batch for this rank: a loader's
    ``shard_id`` and ``num_shards``. Without replicas (0, 1); without a mesh
    every rank is a shard."""
    if replicas is None:
        return 0, 1
    mesh = getattr(replicas, "mesh", None)
    if mesh is None:
        return replicas.rank, replicas.world
    return mesh.data_index(replicas.rank), mesh.data_shards


def counts_once(replicas) -> bool:
    """Whether this rank's per-sample sums (top-k, the count of labels, the
    validation sums) enter the world-wide sums: the ranks of a spatial group
    hold the same samples, and only the first counts them."""
    mesh = spatial_of(replicas)
    return mesh is None or mesh.spatial_index(replicas.rank) == 0


def take_band(images: torch.Tensor, replicas) -> torch.Tensor:
    """This rank's band of rows of NHWC ``images`` (its data shard), as a
    contiguous tensor; the images as they are without a spatial mesh. The
    rows must divide evenly over the spatial ranks, as the reference's
    ``batch_sharding`` demands of a global array."""
    mesh = spatial_of(replicas)
    if mesh is None:
        return images
    h = images.shape[1]
    if h % mesh.spatial:
        raise ValueError(f"{h} image rows do not divide over the {mesh.spatial} ranks of "
                         "the spatial axis")
    a, b = bands(h, mesh.spatial)[mesh.spatial_index(replicas.rank)]
    return images[:, a:b].contiguous()


def shard_batch(replicas, images, labels):
    """This rank's part of a global NHWC batch (``shard_batch``,
    ``mesh.py:119``): its samples (N over ``dcn × data``) and its band of
    rows (H over ``spatial``); the labels of its samples."""
    shard, shards = data_layout(replicas)
    n = images.shape[0]
    if n % shards:
        raise ValueError(f"a batch of {n} does not divide over {shards} data shards")
    rows = slice(shard * n // shards, (shard + 1) * n // shards)
    return take_band(images[rows], replicas), labels[rows]


def register_planes(replicas, n: int, planes, counts: bool = True) -> None:
    """Record, for a forward of ``n`` images per rank through the planes
    ``[(H, W), ...]`` of the model, each plane's full height by this rank's
    band height and the width (the halo exchanges) and, with ``counts`` (a
    train-mode forward), its global count of rows per channel by this rank's
    count (sync-BN's ``global_rows``): the static band plan, so that nothing
    is read on the host, and a CUDA graph captures every use. Raises if two
    planes that differ give this rank the same key."""
    mesh = spatial_of(replicas)
    i = mesh.spatial_index(replicas.rank)
    for rows, width in planes:
        a, b = bands(rows, mesh.spatial)[i]
        m, total = n * (b - a) * width, n * mesh.data_shards * rows * width
        entries = [(replicas.spatial_planes, (b - a, width), rows, "band rows and width")]
        if counts:
            entries.append((replicas.spatial_counts, m, total, "rows per channel"))
        for table, key, value, what in entries:
            if table.setdefault(key, value) != value:
                raise ValueError(f"spatial partitioning: two planes give rank "
                                 f"{replicas.rank} the same {what} {key} ({table[key]} and "
                                 f"{value} in all); the band plan cannot tell them apart")
