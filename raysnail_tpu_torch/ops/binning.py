"""Supertile-local ray binning ahead of the mesh traversal kernel.

The JAX package's `ops/binning.py` reorders rays WITHIN fixed 4096-lane
supertiles by a coherence key, so that neighbouring lanes walk similar
parts of the BVH; dead and root-missing rays compact to the tail of their
supertile. There the permutation is a (G, B, B) one-hot matrix applied on
the TPU's matrix unit. Here it is the same stable counting sort inside each
supertile, turned into a destination index per lane: `apply` scatters the
fields to their destinations and `unapply` gathers them back. This is plain
PyTorch, not a kernel: the JAX package reaches no Pallas kernel here either.

The destinations equal the ones the JAX package's `perm` encodes, lane for
lane, and apply/unapply round-trip exactly.
"""

from __future__ import annotations

import torch

from raysnail_tpu_torch.ops.bvh_traverse import safe_inv, slab

# supertile size: lanes sorted together (the JAX package's default)
B = 4096
N_KEYS = 9  # 8 entry/dir octants + 1 miss/dead bin

# bins per mode (the miss/dead bin is always the last key)
MODE_KEYS = {"miss": 2, "dir": 9, "entry": 9, "entrydir": 65}


def keys(ox, oy, oz, dx, dy, dz, cap, root_bb, t_min, mode: str):
    """Per-lane bin key in [0, MODE_KEYS[mode]). root_bb: (6,) [min.xyz,
    max.xyz].

    mode "entry": octant (relative to the root-box center) of the point
    where the ray enters the root box. mode "dir": direction octant. mode
    "entrydir": both (64 bins). mode "miss": one live bin (dead/miss
    compaction only)."""
    near, far = slab(root_bb[None, :], (ox, oy, oz), [safe_inv(c) for c in (dx, dy, dz)])
    live = (cap > 0.0) & (near <= far) & (far >= t_min) & (near <= cap)
    nk = MODE_KEYS[mode]
    dead = torch.full_like(ox, nk - 1, dtype=torch.long)
    if mode == "miss":
        return torch.where(live, torch.zeros_like(dead), dead)
    d8 = (dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long()
    if mode == "dir":
        o8 = d8
    else:  # entry / entrydir
        te = torch.clamp_min(near, 0.0)
        cx = 0.5 * (root_bb[0] + root_bb[3])
        cy = 0.5 * (root_bb[1] + root_bb[4])
        cz = 0.5 * (root_bb[2] + root_bb[5])
        o8 = ((ox + dx * te > cx).long() * 4 + (oy + dy * te > cy).long() * 2
              + (oz + dz * te > cz).long())
        if mode == "entrydir":
            o8 = o8 * 8 + d8
    return torch.where(live, o8, dead)


def dest(key, n_keys: int = N_KEYS):
    """Stable counting sort of each B-lane supertile by key -> (N,) int64
    destination of every lane (flat, supertile base included)."""
    n = key.shape[0]
    assert n % B == 0, n
    k2 = key.reshape(-1, B)
    oh = (k2[:, :, None] == torch.arange(n_keys, device=key.device)).long()  # (G, B, K)
    pref = torch.cumsum(oh, dim=1)                      # inclusive rank per key
    tot = pref[:, -1, :]                                # (G, K)
    base = torch.cumsum(tot, dim=1) - tot               # exclusive base per key
    rank = (pref * oh).sum(dim=2)
    basel = (base[:, None, :] * oh).sum(dim=2)
    tile0 = torch.arange(k2.shape[0], device=key.device)[:, None] * B
    return (basel + rank - 1 + tile0).reshape(-1)


def apply(dst, fields):
    """fields: list of (N,) -> list of (N,) sorted: out[dst[i]] = x[i]."""
    out = []
    for x in fields:
        y = torch.empty_like(x)
        y[dst] = x
        out.append(y)
    return out


def unapply(dst, fields):
    """Inverse of `apply`: out[i] = y[dst[i]]."""
    return [y[dst] for y in fields]
