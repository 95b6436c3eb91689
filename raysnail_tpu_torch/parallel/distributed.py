"""Process groups: the counterpart of the JAX package's
`parallel/distributed.py` (`jax.distributed.initialize`).

Every rank runs the same program with one device:

    from raysnail_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()    # torchrun's environment, or one rank
    mesh = make_mesh()          # (tile, sample) over the world

Under torchrun (`torchrun --nproc-per-node 4 prog.py`) `initialize()` reads
the world from the environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK); elsewhere give it an init_method (`tcp://host:port`,
`file:///path`), the world size and the rank. With none of them and no
such environment it sets up a real group of one rank, so that the
collectives of the sharded steps still run. The backend is NCCL for a
CUDA device, one card a rank, and gloo for the CPU. An init that was asked
for and fails raises: there is no single-process fallback.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from raysnail_tpu_torch.config import entry_device

log = logging.getLogger("raysnail")

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device=None,
               timeout: datetime.timedelta | None = None) -> int:
    """Join (or, on its first call, create) the default process group ->
    the world size. device: this rank's device, "cuda" (the default: the
    card of LOCAL_RANK, or of the rank modulo the cards, unless an index is
    given) or "cpu". timeout: how long a collective, the rendezvous
    included, may wait for the other ranks (torch's default without it)."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = entry_device(device if device is not None else "cuda")
    store = None
    if init_method is None and world_size is None and rank is None:
        if all(k in os.environ for k in _TORCHRUN_ENV):
            init_method = "env://"
        else:  # a world of one rank: the store lives in this process
            store, world_size, rank = dist.HashStore(), 1, 0
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            local = os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0))
            index = int(local) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        # the group's card, named: NCCL binds its communicator to it
        backend, kw = "nccl", {"device_id": torch.device("cuda", index)}
    else:
        backend, kw = "gloo", {}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)
    n = dist.get_world_size()
    log.info("distributed: rank %d of %d on %s (%s)", dist.get_rank(), n, dev, backend)
    return n


def gather_image(local_flat: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather the tiles' (P_local, ...) pixel slices over the tile group
    -> (n_tile * P_local, ...), in tile order, on every rank. Every tile's
    slice must have the same shape."""
    local_flat = local_flat.contiguous()
    parts = [torch.empty_like(local_flat) for _ in range(mesh.shape["tile"])]
    dist.all_gather(parts, local_flat, group=mesh.tile_group)
    return torch.cat(parts)
