"""Probes of the BVH traversal: the CUDA probe kernels and their plain
PyTorch versions.

The ports of the TPU probe kernels of `scripts/kern_ab.py` (P1: ray I/O,
walk only, sweep only), `scripts/kern_lat.py` (P2: walk latency per node
step by packet shape) and `scripts/kern_walkvar.py` (P3: the V0-V8 bisect
of what each piece of the real kernel's walk costs), over the packed arrays
of a compiled mesh (`scene._pack_leaf_blocks`: pk_bb (K, M, 8), pk_links
(K, M, 4), pk_tri (B, 24, 128)). They measure the traversal's phases; no
render path calls them. `raysnail_tpu_torch.probes` is their entry point.

On CUDA tensors a wrapper launches its kernel of `csrc/bvh_probes.cu`
(built at first use with nvcc into `_build/`, loaded with ctypes) or
raises; on CPU tensors it runs its plain version. There is no fallback
from a kernel to a plain version.

  probe_io(layout)             the six-field sum per ray, rays read as
                               "soa", "rows", "transpose" or "packed"
  probe_walk(shape)            the walk with near <= bt admission, where a
                               taken leaf lowers bt to min(bt, near) for
                               the whole packet; shape "ray" or "packet"
  probe_sweep(shape)           the Cramer sweep of blocks 0..n_blocks-1
                               for every ray, no walk
  probe_walk_latency(variant)  the walk alone: packets of 32 ("w32", one
                               warp, no block barrier), 128 ("w128"), 1024
                               ("w1024"), 128 with the best-t cap compare
                               ("cap"), and that with the leaf-id buffer
                               and the loop in chunks of 8 leaves ("buf")
  probe_walk_variant(v, shape) the bisect V0-V8 of a walk that admits by
                               the slab alone (no best-t pruning, no cap):
                               V3 walks and buffers, V4 sweeps every leaf
                               a ray's slab admits. The TPU kernel's
                               switches _NOSWEEP and _NOATTR are the
                               traversal kernels' own probe forms
                               (`ops.bvh_traverse.bvh_traverse_form`)

The sweeps (probe_sweep, V4-V8) are the traversal kernels' own
(`csrc/bvh_sweep.cuh`): a warp sweeps each (ray, leaf) primitive-parallel,
one ray after another; shape "ray" reads the leaf from global memory as
`csrc/bvh_traverse.cu` does, "packet" stages it in shared memory by the
bulk copy engine as `csrc/bvh_packet.cu`'s `stream` mode does.

A packet of W rays walks one node order, the octant of the sign of its
rays' summed directions (a ray alone: its own octant), and enters a node
when any of its rays admits it. A packet of another width visits other
nodes, so each width is held against the plain version of its own width.
Every probe returns its float result and exact integers per ray (a packet's
rays all carry the packet's counts): node steps, leaves taken, the last leaf
taken, blocks swept and wins. The near accumulator sums each ray's own near
times 1e-20 in step order, in the kernel and here alike, so it too compares
bit for bit.

On the card every wrapper takes `reps`: its C entry point launches the
kernel that many times back to back on the stream (the outputs are those of
any one launch), the window in which a probe too short for a single call to
be timed from the host is timed. `launches` counts kernel launches per probe
(not plain-version calls).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from raysnail_tpu_torch.geometry.hit import BIG
from raysnail_tpu_torch.ops import _nvcc
from raysnail_tpu_torch.ops.bvh_traverse import LANES, safe_inv

T_MIN = 1e-3            # the probes' fixed t_min (kern_ab.py:95); t_max is BIG
ACC_SCALE = 1e-20       # scale of the near accumulator (kern_lat.py:126)
CHUNK = 8               # leaves per chunk of the buffered walk
NF_TRI = 24

IO_LAYOUTS = ("soa", "rows", "transpose", "packed")
SHAPES = {"ray": 1, "packet": 128}
WALK_MODES = ("bt", "plain", "cap", "buf")
# P2's variants: (packet width, walk mode)
LATENCY_VARIANTS = {"w32": (32, "plain"), "w128": (128, "plain"), "w1024": (1024, "plain"),
                    "cap": (128, "cap"), "buf": (128, "buf")}
VARIANTS = (0, 1, 2, 3, 4, 5, 7, 8)

_lib = None


class WalkOut(NamedTuple):
    value: torch.Tensor   # (N,) f32: bt (probe_walk) or the near accumulator
    steps: torch.Tensor   # (N,) i32 node steps of the ray's packet
    leaves: torch.Tensor  # (N,) i32 leaves the packet took
    last: torch.Tensor    # (N,) i32 block of the last leaf taken, -1 if none


class SweepOut(NamedTuple):
    t: torch.Tensor       # (N,) f32 closest t over the swept blocks, BIG for a miss
    swept: torch.Tensor   # (N,) i32 blocks swept


class VariantOut(NamedTuple):
    acc: torch.Tensor     # (N,) f32 near accumulator
    t: torch.Tensor       # (N,) f32 closest t (BIG below V4)
    steps: torch.Tensor   # (N,) i32
    leaves: torch.Tensor  # (N,) i32 (0 for V0)
    swept: torch.Tensor   # (N,) i32 (0 below V4)
    wins: torch.Tensor    # (N,) i32 sweeps that lowered the ray's t (0 below V7)
    last: torch.Tensor    # (N,) i32 (-1 below V2)
    rec: Optional[torch.Tensor]  # V7: (N,) carried attributes' sum; V8: (5, N) record
    mat: Optional[torch.Tensor]  # V8: (N,) i32, the record's integer (the wins)


def build(verbose: bool = False) -> str:
    """Compile the probe kernels if their library is missing; -> the path."""
    return _nvcc.build_cuda("bvh_probes", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.probe_io_launch.argtypes = [c_int, ptr, c_int, c_int, ptr, ptr]
        lib.probe_walk_launch.argtypes = ([c_int, c_int, ptr, ptr, ptr] + [c_int] * 3
                                          + [c_float, c_int, ptr, ptr, ptr])
        lib.probe_sweep_launch.argtypes = [c_int, ptr, ptr] + [c_int] * 3 + [ptr] * 3
        lib.probe_variant_launch.argtypes = ([c_int, c_int] + [ptr] * 4 + [c_int] * 5
                                             + [ptr] * 6)
        for fn in (lib.probe_io_launch, lib.probe_walk_launch, lib.probe_sweep_launch,
                   lib.probe_variant_launch):
            fn.restype = c_int
        _lib = lib
    return _lib


def launch_keys() -> list:
    """Every key of `launches`."""
    return ([f"io/{layout}" for layout in IO_LAYOUTS]
            + [f"{fam}/{shape}" for fam in ("walk", "sweep") for shape in SHAPES]
            + [f"latency/{variant}" for variant in LATENCY_VARIANTS]
            + [f"variant/V{v}/{shape}" for v in VARIANTS for shape in SHAPES])


launches = {key: 0 for key in launch_keys()}


# -- checks and launch plumbing ------------------------------------------------

def _check(name, a, shape, dtype, device):
    if (a.device != device or a.dtype != dtype or tuple(a.shape) != tuple(shape)
            or not a.is_contiguous()):
        raise ValueError(f"bvh_probes: {name} must be a contiguous {tuple(shape)} {dtype} "
                         f"tensor on {device}, got {tuple(a.shape)} {a.dtype} on {a.device}"
                         f"{'' if a.is_contiguous() else ' (strided)'}")


def _check_rays(origin_xyz, dir_xyz):
    device, n = origin_xyz[0].device, origin_xyz[0].shape[0]
    for i, a in enumerate((*origin_xyz, *dir_xyz)):
        _check(f"ray field {i}", a, (n,), torch.float32, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"bvh_probes: unsupported device {device}")
    return device, n


def _check_tree(pk_bb, pk_links, device):
    k_ord, m = pk_bb.shape[0], pk_bb.shape[1]
    if k_ord not in (1, 8):
        raise ValueError(f"bvh_probes: pk_bb holds {k_ord} node orders, not 1 or 8")
    _check("pk_bb", pk_bb, (k_ord, m, 8), torch.float32, device)
    _check("pk_links", pk_links, (k_ord, m, 4), torch.int32, device)
    return k_ord, m


def _check_prim(pk_tri, device):
    _check("pk_tri", pk_tri, (pk_tri.shape[0], NF_TRI, LANES), torch.float32, device)
    if pk_tri.shape[0] < 1:
        raise ValueError("bvh_probes: pk_tri holds no block")


def _aligned(*tensors):
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError("bvh_probes: the arrays must be 16-byte aligned")


def _fields(tensors):
    """The C entry points' host array of six device pointers."""
    return (ctypes.c_void_p * 6)(*(a.data_ptr() for a in tensors))


def _launch(key, device, count, call):
    """Run `call(lib, cuda stream)` on `device`, raise on a refused launch,
    and add `count` to the probe's launches."""
    with torch.cuda.device(device):
        err = call(_load(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bvh_probes ({key}) kernel launch failed: cudaError {err}")
    launches[key] += count


# -- the plain versions' lockstep engine -----------------------------------------

def _packets(x, width, fill=0.0):
    """(N,) -> (P, W), the last packet padded with `fill`."""
    pad = (-x.shape[0]) % width
    return torch.nn.functional.pad(x, (0, pad), value=fill).reshape(-1, width)


def packet_octants(d, width: int, k_ord: int):
    """The node order of each packet of `width` rays, from directions d (three
    (P, W) tensors, padding lanes zero): the octant of the summed directions,
    summed as the kernels sum them (halving within each 32 rays, then over
    the 32-ray groups left to right); width 1: the ray's own octant."""
    if k_ord != 8:
        return torch.zeros(d[0].shape[0], dtype=torch.long, device=d[0].device)

    def total(x):
        if width == 1:
            return x[:, 0]
        x = x.reshape(x.shape[0], width // 32, 32)
        for half in (16, 8, 4, 2, 1):
            x = x[..., :half] + x[..., half:2 * half]
        x = x[..., 0]
        s = x[:, 0]
        for w in range(1, width // 32):
            s = s + x[:, w]
        return s

    return ((total(d[0]) < 0).long() * 4 + (total(d[1]) < 0).long() * 2
            + (total(d[2]) < 0).long())


def tri_sweep(blk, o, d, bt):
    """Cramer sweep of triangle blocks: blk (..., 24, 128) against rays o, d
    (lists of tensors that broadcast against blk[..., i, :]) -> min(bt, the
    closest t in [T_MIN, BIG]) per ray, reduced over the lanes; bt broadcasts
    like o[0][..., 0]. The formulas and their order are the kernels'."""
    fld = lambda i: blk[..., i, :]
    j, k, ll = fld(0) - o[0], fld(1) - o[1], fld(2) - o[2]
    ax, ay, az = fld(3), fld(4), fld(5)
    ddx, ddy, ddz = fld(6), fld(7), fld(8)
    eihf = ddy * d[2] - d[1] * ddz
    gfdi = d[0] * ddz - ddx * d[2]
    dheg = ddx * d[1] - ddy * d[0]
    denom = ax * eihf + ay * gfdi + az * dheg
    denom = torch.where(torch.abs(denom) < 1e-20, torch.full_like(denom, 1e-20), denom)
    beta = (j * eihf + k * gfdi + ll * dheg) / denom
    akjb = ax * k - j * ay
    jcal = j * az - ax * ll
    blkc = ay * ll - k * az
    gamma = (d[2] * akjb + d[1] * jcal + d[0] * blkc) / denom
    t = -(ddz * akjb + ddy * jcal + ddx * blkc) / denom
    ok = ((beta >= 0.0) & (beta < 1.0) & (gamma > 0.0) & (beta + gamma < 1.0)
          & (t >= T_MIN) & (t <= BIG) & (fld(9) > 0.0))
    t = torch.where(ok, t, torch.full_like(t, BIG))
    return torch.minimum(bt, t.min(dim=-1).values)


def lockstep(origin_xyz, dir_xyz, pk_bb, pk_links, width: int, mode: str = "plain",
             sweep: Optional[str] = None, pk_tri=None, stats: Optional[dict] = None) -> dict:
    """The walk of every packet of `width` rays in lockstep, one node step per
    iteration: what every probe's plain version is cut from.

    mode "plain": admission by the slab test alone; "cap": and near <= BIG;
    "bt": and near <= bt, where a taken leaf sets bt = min(bt, near) for every
    ray of its packet ("value" is then bt, else the near accumulator).
    sweep "buf": every ray of a packet sweeps each leaf the packet takes
    (block id from the leaf); "idx": it sweeps block (the leaf's slot in its
    chunk of CHUNK) % B instead. -> per-ray tensors "value", "t", "steps",
    "leaves", "last", "wins" and the carried attributes "a1".."a4" (block, t,
    t before, slot of the last win). `stats` gains what the walk needed:
    "node_tests" and "sweeps" (per ray), "nodes" and "leaves" (distinct ones
    touched)."""
    n = origin_xyz[0].shape[0]
    dev, f32 = origin_xyz[0].device, torch.float32
    k_ord, m = pk_bb.shape[0], pk_bb.shape[1]
    o = [_packets(a, width) for a in origin_xyz]
    d = [_packets(a, width) for a in dir_xyz]
    inv = [safe_inv(c) for c in d]
    n_pkt = o[0].shape[0]
    live = _packets(torch.ones(n, dtype=torch.bool, device=dev), width, False)
    base = packet_octants(d, width, k_ord) * m
    bbf = pk_bb.reshape(-1, 8)
    lk = pk_links.reshape(-1, 4).long()

    per_ray = lambda v, dt: torch.full((n_pkt, width), v, dtype=dt, device=dev)
    per_pkt = lambda v: torch.full((n_pkt,), v, dtype=torch.long, device=dev)
    value = per_ray(BIG if mode == "bt" else 0.0, f32)
    bt = per_ray(BIG, f32)
    wins = per_ray(0, torch.long)
    a1, a2, a3, a4 = (per_ray(0.0, f32) for _ in range(4))
    node, steps, leaves, last = per_pkt(0), per_pkt(0), per_pkt(0), per_pkt(-1)
    if stats is not None:
        seen = torch.zeros(bbf.shape[0], dtype=torch.bool, device=dev)
        seen_leaf = torch.zeros(pk_tri.shape[0] if sweep else 0, dtype=torch.bool, device=dev)
        node_tests = sweeps = 0

    act = torch.arange(n_pkt, device=dev)
    if m == 0:
        act = act[:0]
    while act.numel():
        row = base[act] + node[act]
        b = bbf[row]
        lv = live[act]
        a = [(b[:, c, None] - o[c % 3][act]) * inv[c % 3][act] for c in range(6)]
        near = torch.maximum(torch.maximum(torch.minimum(a[0], a[3]), torch.minimum(a[1], a[4])),
                             torch.minimum(a[2], a[5]))
        far = torch.minimum(torch.minimum(torch.maximum(a[0], a[3]), torch.maximum(a[1], a[4])),
                            torch.maximum(a[2], a[5]))
        admit = lv & (near <= far) & (far >= T_MIN)
        if mode == "bt":
            admit = admit & (near <= value[act])
        elif mode == "cap":
            admit = admit & (near <= BIG)
        any_ = admit.any(dim=1)
        links = lk[row]
        leaf = links[:, 1] > 0
        take = any_ & leaf
        if mode == "bt":
            value[act] = torch.where(take[:, None] & lv, torch.minimum(value[act], near),
                                     value[act])
        else:
            value[act] = torch.where(lv, value[act] + near * ACC_SCALE, value[act])
        if stats is not None:
            node_tests += int(lv.sum())
            seen[row] = True
        if sweep is not None and bool(take.any()):
            tk = act[take]
            slot = leaves[tk] % CHUNK
            blk = links[take, 0] if sweep == "buf" else slot % pk_tri.shape[0]
            col = lambda v: [c[tk][:, :, None] for c in v]
            old = bt[tk]
            new = tri_sweep(pk_tri[blk, :10][:, None], col(o), col(d), old)
            new = torch.where(live[tk], new, old)
            win = new < old
            wins[tk] += win
            a1[tk] = torch.where(win, blk[:, None].to(f32), a1[tk])
            a2[tk] = torch.where(win, new, a2[tk])
            a3[tk] = torch.where(win, old, a3[tk])
            a4[tk] = torch.where(win, slot[:, None].to(f32), a4[tk])
            bt[tk] = new
            if stats is not None:
                sweeps += int(live[tk].sum())
                seen_leaf[blk] = True
        last[act] = torch.where(take, links[:, 0], last[act])
        leaves[act] += take
        steps[act] += 1
        node[act] = torch.where(any_ & ~leaf, node[act] + 1, links[:, 2])
        act = act[node[act] < m]
    if stats is not None:
        for key, val in (("node_tests", node_tests), ("sweeps", sweeps),
                         ("nodes", int(seen.sum())), ("leaves", int(seen_leaf.sum()))):
            stats[key] = stats.get(key, 0) + val

    ray = lambda x: x.reshape(-1)[:n]
    pkt = lambda x: x.to(torch.int32).repeat_interleave(width)[:n]
    return {"value": ray(value), "t": ray(bt), "steps": pkt(steps), "leaves": pkt(leaves),
            "last": pkt(last), "wins": ray(wins).to(torch.int32),
            "a1": ray(a1), "a2": ray(a2), "a3": ray(a3), "a4": ray(a4)}


# -- P1: ray I/O -------------------------------------------------------------------

def pack_rays(origin_xyz, dir_xyz):
    """The "packed" layout: one (N, 8) record [o.xyz, d.xyz, 0, 0] per ray."""
    zero = torch.zeros_like(origin_xyz[0])
    return torch.stack([*origin_xyz, *dir_xyz, zero, zero], dim=1).contiguous()


def probe_io_plain(origin_xyz, dir_xyz):
    """((((ox + dx) + oy) + dy) + oz) + dz per ray, in the kernel's order."""
    (ox, oy, oz), (dx, dy, dz) = origin_xyz, dir_xyz
    return ((((ox + dx) + oy) + dy) + oz) + dz


def probe_io(origin_xyz, dir_xyz, layout: str = "soa", packed=None, reps: int = 1):
    """The six-field sum per ray -> (N,) f32, with the rays read in `layout`.
    "packed" reads `packed`, the (N, 8) records of `pack_rays` (made here
    when None); the other layouts read the six arrays."""
    if layout not in IO_LAYOUTS:
        raise ValueError(f"probe_io: unknown layout {layout!r}")
    device, n = _check_rays(origin_xyz, dir_xyz)
    if device.type == "cpu":
        return probe_io_plain(origin_xyz, dir_xyz)
    src = [*origin_xyz, *dir_xyz]
    if layout == "packed":
        if packed is None:
            packed = pack_rays(origin_xyz, dir_xyz)
        _check("packed", packed, (n, 8), torch.float32, device)
        src = [packed] * 6
    _aligned(*src)
    out = torch.empty(n, dtype=torch.float32, device=device)
    fields = _fields(src)
    _launch(f"io/{layout}", device, reps, lambda lib, s: lib.probe_io_launch(
        IO_LAYOUTS.index(layout), fields, n, int(reps), out.data_ptr(), s))
    return out


# -- P1 walk and P2: the walk alone ---------------------------------------------------

def _walk_plain(origin_xyz, dir_xyz, pk_bb, pk_links, width, mode, stats=None):
    # the leaf-id buffer and its chunks change no count and no sum
    res = lockstep(origin_xyz, dir_xyz, pk_bb, pk_links, width,
                   mode="cap" if mode == "buf" else mode, stats=stats)
    return WalkOut(res["value"], res["steps"], res["leaves"], res["last"])


def _walk(key, origin_xyz, dir_xyz, pk_bb, pk_links, width, mode, reps=1):
    device, n = _check_rays(origin_xyz, dir_xyz)
    k_ord, m = _check_tree(pk_bb, pk_links, device)
    if device.type == "cpu":
        return _walk_plain(origin_xyz, dir_xyz, pk_bb, pk_links, width, mode)
    _aligned(pk_bb, pk_links)
    value = torch.empty(n, dtype=torch.float32, device=device)
    ints = torch.empty((3, n), dtype=torch.int32, device=device)
    fields = _fields([*origin_xyz, *dir_xyz])
    _launch(key, device, reps, lambda lib, s: lib.probe_walk_launch(
        width, WALK_MODES.index(mode), fields, pk_bb.data_ptr(), pk_links.data_ptr(), n, m,
        k_ord, BIG, int(reps), value.data_ptr(), ints.data_ptr(), s))
    return WalkOut(value, ints[0], ints[1], ints[2])


def probe_walk_plain(origin_xyz, dir_xyz, pk_bb, pk_links, shape: str = "packet", stats=None):
    return _walk_plain(origin_xyz, dir_xyz, pk_bb, pk_links, SHAPES[shape], "bt", stats=stats)


def probe_walk(origin_xyz, dir_xyz, pk_bb, pk_links, shape: str = "packet",
               reps: int = 1) -> WalkOut:
    """Walk only (kern_ab.py walk_kernel): `value` is bt per ray."""
    return _walk(f"walk/{shape}", origin_xyz, dir_xyz, pk_bb, pk_links, SHAPES[shape], "bt",
                 reps)


def probe_walk_latency_plain(origin_xyz, dir_xyz, pk_bb, pk_links, variant: str, stats=None):
    width, mode = LATENCY_VARIANTS[variant]
    return _walk_plain(origin_xyz, dir_xyz, pk_bb, pk_links, width, mode, stats)


def probe_walk_latency(origin_xyz, dir_xyz, pk_bb, pk_links, variant: str,
                       reps: int = 1) -> WalkOut:
    """The walk alone (kern_lat.py): `value` is each ray's near accumulator.
    The best-t cap of "cap" and "buf" is BIG, as in the TPU probe: what is
    timed is its compare."""
    width, mode = LATENCY_VARIANTS[variant]
    return _walk(f"latency/{variant}", origin_xyz, dir_xyz, pk_bb, pk_links, width, mode, reps)


# -- P1 sweep ---------------------------------------------------------------------------

def probe_sweep_plain(origin_xyz, dir_xyz, pk_tri, n_blocks=None):
    """Both shapes sweep the same blocks for every ray: one plain version."""
    n_blocks = pk_tri.shape[0] if n_blocks is None else n_blocks
    col = lambda v: [c[:, None] for c in v]
    o, d = col(origin_xyz), col(dir_xyz)
    bt = torch.full_like(origin_xyz[0], BIG)
    for b in range(n_blocks):
        bt = tri_sweep(pk_tri[b, :10], o, d, bt)
    return SweepOut(bt, torch.full_like(bt, n_blocks, dtype=torch.int32))


def probe_sweep(origin_xyz, dir_xyz, pk_tri, shape: str = "packet", n_blocks=None,
                reps: int = 1) -> SweepOut:
    """Sweep only (kern_ab.py sweep_kernel): the closest t over blocks
    0..n_blocks-1 (all when None) for every ray."""
    device, n = _check_rays(origin_xyz, dir_xyz)
    _check_prim(pk_tri, device)
    n_blocks = pk_tri.shape[0] if n_blocks is None else int(n_blocks)
    if not 1 <= n_blocks <= pk_tri.shape[0]:
        raise ValueError(f"probe_sweep: n_blocks {n_blocks} is not in 1..{pk_tri.shape[0]}")
    if device.type == "cpu":
        return probe_sweep_plain(origin_xyz, dir_xyz, pk_tri, n_blocks)
    _aligned(pk_tri)
    bt = torch.empty(n, dtype=torch.float32, device=device)
    swept = torch.empty(n, dtype=torch.int32, device=device)
    fields = _fields([*origin_xyz, *dir_xyz])
    _launch(f"sweep/{shape}", device, reps, lambda lib, s: lib.probe_sweep_launch(
        SHAPES[shape], fields, pk_tri.data_ptr(), n, n_blocks, int(reps), bt.data_ptr(),
        swept.data_ptr(), s))
    return SweepOut(bt, swept)


# -- P3: the bisect ---------------------------------------------------------------------

def variant_sweep(v: int):
    """Which sweep of `lockstep` variant v's plain version needs."""
    return None if v < 4 else "idx" if v == 5 else "buf"


def variant_view(v: int, res: dict) -> VariantOut:
    """Variant v's outputs from a `lockstep` run with `variant_sweep(v)`: the
    pieces a variant lacks read 0 (t: BIG, last: -1), as its kernel writes."""
    zero = torch.zeros_like(res["steps"])
    swept = v >= 4
    rec = mat = None
    if v == 7:
        rec = ((res["a1"] + res["a2"]) + res["a3"]) + res["a4"]
    if v == 8:
        rec = torch.stack([res["t"], res["a1"], res["a2"], res["a3"], res["a4"]])
        mat = res["wins"]
    return VariantOut(
        acc=res["value"], t=res["t"] if swept else torch.full_like(res["t"], BIG),
        steps=res["steps"], leaves=res["leaves"] if v >= 1 else zero,
        swept=res["leaves"] if swept else zero, wins=res["wins"] if v >= 7 else zero,
        last=res["last"] if v >= 2 else torch.full_like(zero, -1), rec=rec, mat=mat)


def probe_walk_variant_plain(v, origin_xyz, dir_xyz, pk_bb, pk_links, pk_tri,
                             shape: str = "packet", stats=None) -> VariantOut:
    return variant_view(v, lockstep(origin_xyz, dir_xyz, pk_bb, pk_links, SHAPES[shape],
                                    sweep=variant_sweep(v), pk_tri=pk_tri, stats=stats))


def probe_walk_variant(v, origin_xyz, dir_xyz, pk_bb, pk_links, pk_tri,
                       shape: str = "packet", reps: int = 1) -> VariantOut:
    """Variant v of the bisect (kern_walkvar.py) for shape "ray" or "packet"."""
    if v not in VARIANTS:
        raise ValueError(f"probe_walk_variant: v must be one of {VARIANTS}, got {v}")
    device, n = _check_rays(origin_xyz, dir_xyz)
    k_ord, m = _check_tree(pk_bb, pk_links, device)
    _check_prim(pk_tri, device)
    if device.type == "cpu":
        return probe_walk_variant_plain(v, origin_xyz, dir_xyz, pk_bb, pk_links, pk_tri, shape)
    _aligned(pk_bb, pk_links, pk_tri)
    f32 = dict(dtype=torch.float32, device=device)
    acc, bt = torch.empty(n, **f32), torch.empty(n, **f32)
    ints = torch.empty((5, n), dtype=torch.int32, device=device)
    rec = torch.empty((5, n) if v == 8 else (n,), **f32) if v >= 7 else None
    mat = torch.empty(n, dtype=torch.int32, device=device) if v == 8 else None
    fields = _fields([*origin_xyz, *dir_xyz])
    _launch(f"variant/V{v}/{shape}", device, reps, lambda lib, s: lib.probe_variant_launch(
        v, SHAPES[shape], fields, pk_bb.data_ptr(), pk_links.data_ptr(), pk_tri.data_ptr(),
        n, m, k_ord, pk_tri.shape[0], int(reps), acc.data_ptr(), bt.data_ptr(), ints.data_ptr(),
        rec.data_ptr() if rec is not None else None,
        mat.data_ptr() if mat is not None else None, s))
    return VariantOut(acc, bt, ints[0], ints[1], ints[2], ints[3], ints[4], rec, mat)
