"""The (tile, sample) mesh over the ranks of a torch.distributed group.

The JAX package's `parallel/mesh.py` lays the devices out as a
("tile", "sample") `jax.sharding.Mesh`: pixels are split over "tile",
stratification cells over "sample", and partial radiance sums meet in a sum
over "sample". Here a rank is a process with one device, and the two axes
are process groups: rank r sits at tile r // n_sample and sample
r % n_sample, as JAX's `reshape(n_tile, n_sample)` lays the devices out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def _factor(n: int) -> tuple[int, int]:
    """n -> (tile, sample) with tile the larger, near-square factor."""
    best = (n, 1)
    for t in range(1, int(np.sqrt(n)) + 1):
        if n % t == 0:
            best = (n // t, t)
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (tile, sample) mesh.

    sample_group: the ranks that share this rank's tile (its partial sums
    meet there); tile_group: the ranks that share its sample index (the
    tiles of the image gather there, in tile order)."""
    shape: dict             # {"tile": n_tile, "sample": n_sample}
    size: int
    rank: int
    tile: int               # this rank's coordinates
    sample: int
    device: torch.device
    sample_group: object
    tile_group: object


def _shape(n: int, n_tile: int | None, n_sample: int | None) -> tuple[int, int]:
    """make_mesh's factoring rules (the JAX package's `make_mesh`)."""
    if n_tile is None and n_sample is None:
        n_tile, n_sample = _factor(n)
    elif n_tile is None:
        n_tile = n // n_sample
    elif n_sample is None:
        n_sample = n // n_tile
    if n_tile * n_sample != n:
        raise ValueError(f"a {n_tile} x {n_sample} mesh does not cover {n} ranks")
    return n_tile, n_sample


def _group_device() -> torch.device:
    """The device whose tensors the default group's backend moves: this
    rank's card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_tile: int | None = None, n_sample: int | None = None) -> Mesh:
    """The (tile, sample) mesh over the world of the default process group
    (`distributed.initialize` first). With neither size given the world is
    factored near-square, the tile axis the larger. Collective: every rank
    calls it, with the same sizes, in the same order as its other calls of
    make_mesh, since it creates the axes' groups."""
    n, rank = dist.get_world_size(), dist.get_rank()
    n_tile, n_sample = _shape(n, n_tile, n_sample)
    # dist.new_group is collective: every rank creates every group, in one order
    sample_groups = [dist.new_group([t * n_sample + s for s in range(n_sample)])
                     for t in range(n_tile)]
    tile_groups = [dist.new_group([t * n_sample + s for t in range(n_tile)])
                   for s in range(n_sample)]
    tile, sample = divmod(rank, n_sample)
    return Mesh(shape={"tile": n_tile, "sample": n_sample}, size=n, rank=rank, tile=tile,
                sample=sample, device=_group_device(), sample_group=sample_groups[tile],
                tile_group=tile_groups[sample])
