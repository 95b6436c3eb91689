"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with a CUDA card, nvcc and g++.
It drives `raysnail_tpu_torch` (never the JAX package) through these phases
and exits non-zero if any fails:

  1. device   require CUDA; print the card's name and power limit
  2. build    build every kernel from csrc/ with nvcc (sphere_min_t.cu, K1
              and its backward K1b; bvh_traverse.cu, bvh_packet.cu,
              bvh_probes.cu, mandelbulb_march.cu; rows_select.cu, K7 and
              K7b), and the host BVH builder
              with g++, all started together; the seconds, and
              each kernel's registers and spills (-Xptxas -v); the sphere
              kernel's launch shape, occupancy and waves at 400,000 rays
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the render paths' shapes and at stress shapes; CUDA-event
              times. The packet kernel: tri, tri_mxu, box and sphere, bit for
              bit against the plain version, then `stream` and `two_level`,
              alone and together, bit for bit against the kernel with both
              off; tri_mxu's t against tri's within MXU_RTOL on all but
              MXU_EDGE_SHARE of the rays that both hit. Both traversal
              kernels again on mesh-200k's bounce rays (cosine directions from
              the primary rays' hit points, made from a seeded generator):
              held against the plain version and timed. sphere_min_t on
              example.sdl's primary rays (a), random spheres (b), duplicated
              spheres (c), the static book 1 frame's primary rays, and in its
              moving form on the moving book 1 frame's primary rays (d) and
              on their bounce rays (e): bit for bit, with the pairs that
              take the root. The Mandelbulb march (K6) on the
              mandelbulb-passes4 camera's 150,000 primary rays in tile order,
              on their bounce rays (cosine directions about the hit
              normals from a seeded generator, the rays that missed as dead
              lanes) and on its 600,000 primary rays of 4 samples (more
              threads than the card holds at once): t, valid, normal, uv and
              the step and iteration counts bit for bit; steps per ray, DE
              iterations per step and per ray (max, p99); the chain floor
              (the 32 slowest rays alone in one launch, and the ns a DE
              iteration of the longest); each warp's idle share (a warp
              runs until its slowest ray is done); call, device and plain
              ms, the bound and the issue floor without FMA.
              Every traversal probe (ray I/O, walk, sweep, walk latency, the
              V0-V8 bisect) against its plain version, on the probes' own
              case knot-9600 and on mesh-200k: integers and min-t bit for
              bit, the near accumulator within probes.ACC_RTOL. The rows'
              select K7 and its fixed-order transpose K7b on the material
              rows of the hits of example.sdl's and the static book 1
              frame's primary rays (K = 4), example.sdl's texture rows of
              the same hits (K = 3 and 6), the same three in a random order
              (the regen-shuffle integrator's bounce rays come shuffled:
              a segment of 32 rays then holds up to 10 rows), and on
              book 1's rows spread over 1,024 (K = 4) and 4,096 rows
              (K = 6): K7 bit for bit against its plain version and
              index_select, K7b bit for bit against its plain version on
              two calls; the share of K7b's segments by the rows they
              hold, and K7b's route (one launch, or a second launch for
              the chunks' sum; row tiles); call, device (warm and
              L2-cold) and plain ms, the library calls' call and device ms
              (index_select; index_add, also under
              torch.use_deterministic_algorithms, and whether each repeats
              its bits) and the bounds
  4. golden   the anchors example.sdl, mesh, mesh-binned, boxfield-kernel,
              book1-spherebvh, book1, cornell, quadric.sdl, csg.sdl and
              mandelbulb on the card, against the committed
              tests/golden/golden.npz, with the kernel launches of each; the open anchor book2 (OPEN_ANCHORS:
              its mean held, its thumbnail reported), which must launch the
              box kernel and K1's moving form; then the mesh, box and sphere
              anchors forced through the packet kernel in every (kind, stream,
              two_level) mode, each against its anchor's statistics
  5. main     the probes' entry point, probes.main(["all", "--case",
              "mesh-200k"]), with every probe's launch count read after it;
              the canonical frame, example.sdl at 800x500@64spp (a warm-up
              through the CLI, then a timed run of the same calls, which
              must launch K7 in every shade iteration); one
              sdl/transforms.sdl frame (its ellipsoid is a quadric) and one
              book 1 frame with moving balls and an open shutter, both at
              800x500@16spp; the mesh-200k frame, a 204,800-triangle knot at
              320x200@16spp, depth 6, through the per-ray kernel (with
              "entry" binning and with none) and through the packet kernel
              (tri, tri with two_level, tri_mxu and tri_mxu with stream), and
              once through the tile-ordered sample-step path (render_sums),
              held against the frame step's image; the mesh-800k frame,
              819,200 triangles, whose leaf blocks turn `stream` on by the
              auto rule, with the port's 8 node orders and on the one node
              order that the JAX package's node cap leaves it, and one call
              of all its primary rays on each tree (streamed, resident,
              per-ray kernel); the packet kernel on the one-order tree, held
              against its plain version on 8,192 of its primary rays; the 9,600-triangle
              mesh+arealight frame; a passes=2 render of example.sdl at
              800x500@16spp; the CSG and media frames of CSG_FRAMES
              (quadric.sdl, csg.sdl and declares.sdl 800x500@16spp, book2
              and cornell-smoke 400x400@25spp depth 8),
              each a first frame with its kernel launches per shade iteration
              and its peak memory; mandelbulb-passes4 (500x300@25spp, depth
              6, passes 4, seed 7, as bench.py), whose K6 launches must equal
              its intersect calls; two example.sdl frames at 200x125@16spp
              through the scan integrator, one with path_regen="never" and
              one with rng="threefry", each through K1 and with its channel
              means within SCAN_MEAN_ATOL of the default frame's. Each run
              reads the kernel launch counts it made, and the run prints its
              total seconds.
  6. train    the gradient train step (`raysnail_tpu_torch.diff`): (a) K1b,
              the backward of the sphere sweep (`sphere_min_t_bwd`, the
              second entry point of csrc/sphere_min_t.cu), bit for bit
              against its plain version on K1's output for example.sdl's
              400,000 primary rays x 4 spheres, the static book 1 rays x 478
              and the moving book 1 rays x 481 (moving form), each with a
              seeded cotangent: call, device and plain ms and the bound;
              (b) render_image_diff's gradient on the card against the CPU's
              (example.sdl and a DiffuseMetal/BlinnPhong "metal" scene at
              32x20@4spp, depth 4, each leaf within GRAD_RTOL * max|g| +
              GRAD_ATOL, flipped pixels left out), and tests/test_diff.py's
              mesh scene: K2 runs, every gradient finite; one Adam step of
              the metal scene at 400x250@16, depth 8, whose bounce rays' t
              reaches the gradient through K1b (K1b's main-path launches),
              run twice on the same inputs: the same bits in all 10
              leaves (as int32 patterns: the lobes' NaN traps included);
              (c) bench.py's example-fwd+bwd row, 400x250@16 depth 8,
              Adam(1e-2), a zero target: a warm-up step, then TRAIN_STEPS
              timed steps (seconds a step, Mrays/s fwd+bwd, the loss, the
              peak memory, the launches a step), K1's launches split into
              pass 1, the cells' forward and their recompute, and a step
              without remat for its peak memory; (d) the canonical step,
              800x500@64 depth 8 (one backward pass a cell), the launches
              of one of its cells, the cell under the profiler, and its
              backward pass alone under the profiler beside the metal
              scene's cell at the same size: no index_add op or kernel
              (nor index_put's accumulating kernel) may run there; K7b's
              and K1b's device time in place, K1b's against its bound for
              the rays of its calls; (e) the
              inverse-rendering example, EXAMPLE_STEPS Adam(2e-2) steps at
              64x48@16 depth 4, whose loss must fall
  7. sharded  the port's sharding (`raysnail_tpu_torch.parallel`) on cuda:0 in
              a one-rank NCCL group (`distributed.initialize`, `make_mesh`):
              (a) the sharded frame step on the canonical frame (example.sdl
              800x500@64, depth 8, seed 0) bit for bit against
              `make_frame_step`, both timed warm (single, sharded, sharded,
              single), and the all_reduce of its 400,000 x 3 sums alone
              (CUDA events) against its bound (the bytes read and written
              once at the HBM rate); (b) `render_sharded` at the same size
              against `render_sums` in tile order (SHARD_ATOL), with its
              peak memory; (c) `render_passes` with the padded sharded step,
              the sharded frame step and passes=2 at 800x500@16 against the
              single-device passes (SHARD_ATOL); (d) a `RenderSession`
              through the padded step cancelled after its first chunk,
              checkpointed, resumed and finished, against an uninterrupted
              session: exact; (e) `make_sharded_train_step` at
              example-fwd+bwd's size, one SGD step of lr 1 (so p0 - p1 is
              the gradient) against `diff.make_train_step`'s, each leaf
              within GRAD_RTOL * max|g| + GRAD_ATOL, the seconds of each
              step, and each step twice on the same inputs: the same bits in
              all 10 leaves, or the phase fails; (f) the dry run's forced
              mesh check
              (`dryrun.check_mesh_kernel`: K2). K1's and K2's launches in
              the phase's runs, each read just after its run
  8. profile  (only with --profile, after the phases above) device time per call
              (device_ms: calls queued behind a spin kernel, CUDA events) of
              sphere_min_t on (a), static book 1, (d) and (e); K1's static
              form against K4 (per ray, packet) on random sphere groups of
              CROSSOVER_S spheres; each traversal kind on the primary and on
              the bounce rays; torch.profiler over the moving book 1 frame,
              one mesh-200k frame per configuration, the mesh-800k frames,
              the five CSG and media frames and the first pass of
              mandelbulb-passes4: device time by kernel, the
              named kernels' share, cudaLaunchKernel calls and the device's
              busy share; and the cudaLaunchKernel calls that each CSG and
              media frame's trees and media add to one intersect call

The last two lines are the kernels' JSON record (with each kernel's bound:
the least time the card could take for the bytes and the FP32 operations
that this run's rays needed; for sphere_min_t also its issue floor, the
same operations issued one a lane a clock, as the -fmad=false build issues
them) and {"ok": true, "device": {...}}. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "sdl", "example.sdl")
WIDTH, HEIGHT, SAMPLES = 800, 500, 65       # the canonical command's frame
MESH_W, MESH_H, MESH_SPP, MESH_DEPTH, MESH_SEED = 320, 200, 16, 6, 1  # bench.py:220-238
KNOT_200K, KNOT_800K, KNOT_AREA = (1600, 64), (6400, 64), (200, 24)  # (n_seg, n_ring)
TIMING_RUNS = 20
PLAIN_RUNS = 3                               # the plain BVH walk takes up to seconds
ANCHORS = ("example.sdl", "mesh", "mesh-binned", "boxfield-kernel", "book1-spherebvh",
           "book1", "cornell", "quadric.sdl", "csg.sdl", "mandelbulb")
# rendered and reported, thumbnail not held: book 2's moves beyond THUMB_ATOL
# with the rounding of one sphere quadratic (tests/test_torch_media.py::
# test_book2_thumbnail_moves_with_rounding; the JAX package run op by op
# misses it too)
OPEN_ANCHORS = ("book2",)
TRANSFORMS = os.path.join(ROOT, "sdl", "transforms.sdl")
SMALL_SPP = 16                               # the transforms.sdl and moving book 1 frames
BIG = 1e30
SINGLE_ORDER_CAP = 4600                      # the JAX package's node cap: one order above it
SUMS_ATOL = 1e-3                             # render_sums' image against the frame step's
PASSES_SAMPLES = 16                          # the passes=2 frame's requested spp
# CSG and media: (label, SDL file or scene, width, height, requested spp,
# depth, seed); book2 and cornell-smoke at bench.py:177-191's sizes and
# seed, quadric.sdl at bench.py:170-172's width with 16 spp (65 until the
# Mandelbulb's phases came, to keep the run's time), csg.sdl and
# declares.sdl beside it
CSG_FRAMES = (("quadric.sdl", "quadric.sdl", 800, 500, 16, 8, 1),
              ("csg.sdl", "csg.sdl", 800, 500, 16, 8, 1),
              ("declares.sdl", "declares.sdl", 800, 500, 16, 8, 1),
              ("book2", "book2", 400, 400, 25, 8, 1),
              ("cornell-smoke", "cornell-smoke", 400, 400, 25, 8, 1))
# mandelbulb-passes4 (bench.py:240-250, render_passes seed bench.py:76)
BULB_W, BULB_H, BULB_SPP, BULB_DEPTH, BULB_PASSES, BULB_SEED = 500, 300, 25, 6, 4, 7
# K6's largest case: that camera's primary rays of 4 samples (600,000)
BULB_MANY_SAMPLES = 4
# the scan and threefry frames of example.sdl, and the largest difference of
# a channel mean from the default frame's: the fast scan traces the default
# frame's paths, threefry draws other numbers (CPU reading at 96x64@4spp:
# 8.9e-4, tests/test_torch_scan.py)
SCAN_W, SCAN_H, SCAN_SPP, SCAN_MEAN_ATOL = 200, 125, 16, 0.01
# the gradient train step (phase 6): bench.py's fwd+bwd rows (bench.py:94-141),
# example-fwd+bwd 400x250@16 and example-fwd+bwd-800x500, depth 8, Adam(1e-2),
# a zero target; a warm-up step, then TRAIN_STEPS timed steps of the first
TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_STEPS = 400, 250, 16, 3
TRAIN_DEPTH = 8
# the card's gradient against the CPU's: render_image_diff's mean at 32x20@4spp,
# depth 4; each leaf within GRAD_RTOL * max|g_cpu| + GRAD_ATOL, the pixels
# whose radiance differs beyond FLIP_ATOL (a path flipped by an ulp, at most
# FLIP_SHARE of them) left out of the scalar on both sides
GRAD_W, GRAD_H, GRAD_SPP, GRAD_DEPTH = 32, 20, 4, 4
GRAD_RTOL, GRAD_ATOL, FLIP_ATOL, FLIP_SHARE = 1e-3, 1e-6, 1e-4, 0.01
EXAMPLE_STEPS = 10  # the inverse-rendering example's steps on the card
# the sharded phase (7): images of the sharded paths against their
# single-device counterparts (the JAX package's tests' tolerance for two
# orders of the same sums), and the passes frame's requested spp
SHARD_ATOL = 2e-5
# K1b's FP32 operations per ray that hit (compares, selects and negations
# included, the division and the square root one each), and the moving
# center's, counted from csrc/sphere_min_t.cu
BWD_OPS, BWD_MOVE_OPS = 44, 6
WARP = 32
# the card's published peaks (H100 SXM): device memory bytes/s, FP32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12
# FP32 operations of one (ray, primitive) test per leaf kind, of one (ray,
# node) slab test, and of one (ray, sphere) test of sphere_min_t, counted
# from the kernels' sources (compares included)
PAIR_FLOPS = {"tri": 55, "tri_mxu": 88, "box": 32, "sphere": 27}
NODE_FLOPS = 22
# sphere_min_t's FP32 operations: of every (ray, sphere) pair up to its ok
# test (delta > 0), of the moving center, and of the root where ok holds
# (sqrt, two roots, four range tests, the select and the compare with the
# best); the kernel takes the root only there
SMT_PAIR_OPS, SMT_MOVE_OPS, SMT_ROOT_OPS = 17, 6, 10
# operations a second when each issues on its own, one a lane a clock: the
# kernels are built with -fmad=false, and FP32_FLOPS counts an FMA as two
FP32_NO_FMA = FP32_FLOPS / 2
CROSSOVER_S = (64, 256, 1024, 2048, 4096, 8192)  # static sphere counts, K1 against K4


def bound(n_bytes: float, n_flops: float) -> dict:
    """The least milliseconds the card could take: the larger of the bytes
    over the memory rate and the operations over the FP32 rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def bvh_bound(kind: str, n: int, n_hit: int, stats: dict) -> dict:
    """Bound of one traversal from what its rays needed (the plain version's
    count): 13 words of ray input and output per ray, each touched node's
    bounds and links once, of each touched leaf block the rows that the
    sweep reads once, and the winner's attribute words per ray that hit; a
    slab test per (ray, node) and 128 primitive tests per (ray, leaf) sweep."""
    from raysnail_tpu_torch.ops.bvh_traverse import ATTR_WORDS, STAGED_FLOATS

    n_bytes = (n * 13 * 4 + stats["nodes"] * 48 + stats["leaves"] * STAGED_FLOATS[kind] * 4
               + n_hit * ATTR_WORDS[kind] * 4)
    return bound(n_bytes, stats["node_tests"] * NODE_FLOPS
                 + stats["sweeps"] * 128 * PAIR_FLOPS[kind])


def phase(name: str, msg: str):
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median milliseconds of `fn` over `runs` calls, by CUDA events, after
    one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sphere_case(gen: torch.Generator, n: int, s: int, device, duplicate=False):
    """Random rays and spheres (unit directions; spheres in a 20^3 box; every
    7th sphere inactive). duplicate=True lists every sphere twice, side by
    side, so that t ties exactly."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=gen, device=device) * (hi - lo) + lo

    o = u(3, n, lo=-15.0, hi=15.0)
    d = torch.randn(3, n, generator=gen, device=device)
    d = d / d.norm(dim=0, keepdim=True)
    m = s // 2 if duplicate else s
    c = u(3, m, lo=-10.0, hi=10.0)
    r = u(m, lo=0.3, hi=1.5)
    active = torch.ones(m, dtype=torch.bool, device=device)
    active[::7] = False
    if duplicate:
        c = c.repeat_interleave(2, dim=1)
        r = r.repeat_interleave(2)
        active = active.repeat_interleave(2)
    return (tuple(o.contiguous()), tuple(d.contiguous()), tuple(c.contiguous()),
            (r * r).contiguous(), active)


def check_sphere_kernel(args, t_min, t_max, label: str, time_it: bool, motion=None):
    """Kernel vs plain on the same inputs: idx equal, t bit-equal (the kernel
    is built with -fmad=false, so both round every operation alike). motion =
    {"speed_xyz", "time"} checks the moving form."""
    from raysnail_tpu_torch.ops.sphere_min_t import sphere_min_t, sphere_min_t_plain

    motion = motion or {}
    before = (sphere_min_t.launches, sphere_min_t.moving_launches)
    t_k, i_k = sphere_min_t(*args, t_min, t_max, **motion)
    t_p, i_p = sphere_min_t_plain(*args, t_min, t_max, **motion)
    torch.cuda.synchronize()
    err = float((t_k - t_p).abs().max())
    same_idx = bool(torch.equal(i_k, i_p))
    n_hit = int((t_p < BIG).sum())
    n, s = args[0][0].shape[0], args[3].shape[0]
    moving = bool(motion)
    stats = root_stats(args, motion)
    ops = (stats["pairs"] * (SMT_PAIR_OPS + SMT_MOVE_OPS * moving)
           + stats["roots"] * SMT_ROOT_OPS)
    out = {"max_abs_err": err, "idx_equal": same_idx, "hits": n_hit, **stats,
           **bound(n * (8 + moving) * 4 + s * (5 + 3 * moving) * 4, ops),
           "issue_floor_ms": ops / FP32_NO_FMA * 1e3}
    if time_it:
        out["ms"] = time_ms(lambda: sphere_min_t(*args, t_min, t_max, **motion))
        out["plain_ms"] = time_ms(lambda: sphere_min_t_plain(*args, t_min, t_max, **motion))
    # comparison launches are not the main path's
    sphere_min_t.launches, sphere_min_t.moving_launches = before
    phase("kernels", f"sphere_min_t {label}: N={n} S={s} hits={n_hit} "
          f"max|dt|={err!r} idx_equal={same_idx}; pairs {stats['pairs']}, "
          f"{stats['roots']} with delta > 0 (the root); bound {out['bound_ms']!r} ms by "
          f"{out['bound_by']}, issue floor without FMA {out['issue_floor_ms']!r} ms"
          + (f"; kernel {out['ms']!r} ms, plain {out['plain_ms']!r} ms (median of "
             f"{TIMING_RUNS})" if time_it else ""))
    if not same_idx or err != 0.0:
        raise AssertionError(f"sphere_min_t {label}: kernel disagrees with the plain "
                             f"version (max|dt|={err}, idx_equal={same_idx})")
    return out, (t_k, i_k)


ROWS_1024, ROWS_4096 = 1024, 4096  # K7b's row counts beside the scenes' (its cost by R)


def hit_rows(scene, ray, cfg) -> torch.Tensor:
    """The material row of each ray's closest hit (row 0 where it missed),
    int64: the indices that `materials.gather` selects with."""
    from raysnail_tpu_torch import scene as scene_mod

    hit = scene_mod.intersect(scene, scene.arrays, ray, cfg.t_min, cfg.t_max)
    return torch.clamp_min(hit.mat_id, 0).long().contiguous()


def segment_rows(idx) -> dict:
    """K7b's segments (32 consecutive rays) by the rows they hold: the share
    of the whole segments with 1, 2-4, 5-8, 9-16 and 17-32 rows, and the
    mean."""
    from raysnail_tpu_torch.ops import rows_select as rs

    n = idx.shape[0] - idx.shape[0] % rs.SEGMENT
    seg = idx[:n].view(-1, rs.SEGMENT).sort(dim=1).values
    d = 1 + (seg[:, 1:] != seg[:, :-1]).sum(dim=1)
    bins = {"1": (1, 1), "2-4": (2, 4), "5-8": (5, 8), "9-16": (9, 16), "17-32": (17, 32)}
    out = {b: float(((d >= lo) & (d <= hi)).float().mean()) for b, (lo, hi) in bins.items()}
    out["mean"] = float(d.float().mean())
    return out


def k7b_route(rows: int, k: int) -> str:
    """K7b's launches for an (R, K) table (csrc/rows_select.cu's
    launch_bwd): one launch, or two (a second for the chunks' sum); the
    row tiles' kernel above kSmemBudget's entries."""
    with open(os.path.join(ROOT, "raysnail_tpu_torch", "csrc", "rows_select.cu")) as f:
        src = f.read()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    budget = int(re.search(r"kSmemBudget = (\d+) \* 1024", src)[1]) * 1024
    most = budget // (const["kChunkRuns"] * 4)
    if rows * k > most:
        return f"two launches, row tiles of {most // k}"
    return "one launch" if rows * k <= const["kOneLaunchEntries"] else "two launches"


def rows_cases(scene, ray, cfg, sscene, sray, vcfg, gen) -> dict:
    """K7's and K7b's cases -> {name: (idx, rows, k, label)}: the material
    rows of example.sdl's and the static book 1 frame's primary rays' hits
    (K = 4, materials.gather), example.sdl's texture rows of the same hits
    (K = 3, the base color; K = 6, the checker's two colors), those three
    in a random order (the regen-shuffle integrator's bounce rays come
    shuffled), and the book 1 rows spread over 1,024 and 4,096 rows."""
    idx_ex = hit_rows(scene, ray, cfg)
    n_ex = scene.arrays.materials.mtype.shape[0]
    tex_ex = torch.clamp_min(scene.arrays.materials.tex_id[idx_ex], 0).long()
    n_tex = scene.arrays.textures.ttype.shape[0]
    idx_b1 = hit_rows(sscene, sray, vcfg)
    n_b1 = sscene.arrays.materials.mtype.shape[0]
    shuffle = torch.randperm(idx_ex.shape[0], generator=gen, device=idx_ex.device)
    spread = lambda rows: (idx_b1 * rows) // n_b1 + torch.randint(  # noqa: E731
        0, rows // n_b1, idx_b1.shape, generator=gen, device=idx_b1.device)
    return {
        "example.sdl": (idx_ex, n_ex, 4, "example.sdl primary rays' material rows"),
        "textures3": (tex_ex, n_tex, 3, "example.sdl primary rays' texture rows, K = 3"),
        "textures6": (tex_ex, n_tex, 6, "example.sdl primary rays' texture rows, K = 6"),
        "shuffled": (idx_ex[shuffle], n_ex, 4, "example.sdl's material rows, shuffled"),
        "textures3_shuffled": (tex_ex[shuffle], n_tex, 3,
                               "example.sdl's texture rows, shuffled, K = 3"),
        "textures6_shuffled": (tex_ex[shuffle], n_tex, 6,
                               "example.sdl's texture rows, shuffled, K = 6"),
        "book1": (idx_b1, n_b1, 4, "static book 1 primary rays' material rows"),
        "1024": (spread(ROWS_1024), ROWS_1024, 4, f"book 1's rows spread over {ROWS_1024}"),
        "4096": (spread(ROWS_4096), ROWS_4096, 6,
                 f"book 1's rows spread over {ROWS_4096}, K = 6")}


def check_rows_select(idx, rows: int, k: int, gen, label: str) -> dict:
    """K7 and K7b against their plain versions on `idx` (N,) int64 with a
    seeded (rows, k) table and (N, k) cotangent, passed to the wrappers as
    their k strided columns: K7 bit-equal to the plain
    gather and to index_select; K7b bit-equal to its plain version, and to
    itself on a second call. Call, device (warm and L2-cold) and plain ms;
    the library calls' call and device ms: index_select for K7; index(0,
    idx, g) into zeros (index_add_'s out-of-place form) for K7b, also under
    torch.use_deterministic_algorithms(True), and whether each repeats its
    bits; each kernel's bound (the index, the rays' K columns and the
    table's once); K7b's segments by their rows, and its route."""
    from raysnail_tpu_torch.ops import rows_select as rs

    n, device = idx.shape[0], idx.device
    table = torch.randn(rows, k, generator=gen, device=device)
    g = torch.randn(n, k, generator=gen, device=device)
    zeros = torch.zeros(rows, k, device=device)
    cols, gs = table.unbind(1), g.unbind(1)
    fwd = lambda: rs.rows_select(cols, idx)  # noqa: E731
    bwd = lambda: rs.rows_select_bwd(gs, idx, rows)  # noqa: E731
    add = lambda: zeros.index_add(0, idx, g)  # noqa: E731
    select = lambda: torch.index_select(table, 0, idx)  # noqa: E731
    with counts_kept():
        out, grads = fwd().t(), [torch.stack(bwd(), 1) for _ in range(2)]
        want_out = rs.rows_select_plain(table, idx)
        want = rs.rows_select_bwd_plain(g, idx, rows)
        added = [add(), add()]
        torch.cuda.synchronize()
        fwd_same = torch.equal(out, want_out) and torch.equal(out, select())
        bwd_same = all(torch.equal(x, want) for x in grads)
        n_bytes = n * 8 + n * k * 4 + rows * k * 4
        res = {"rows": rows, "columns": k, "rays": n,
               "fwd_bit_equal": fwd_same, "bwd_bit_equal": bwd_same,
               "segment_rows": segment_rows(idx), "route": k7b_route(rows, k),
               "max_abs_err": max(float((out - want_out).abs().max()),
                                  float((grads[0] - want).abs().max())),
               "fwd": {"ms": time_ms(fwd), "device_ms": device_ms(fwd),
                       "cold_device_ms": device_ms(fwd, cold=True),
                       "plain_ms": time_ms(lambda: rs.rows_select_plain(table, idx)),
                       "library_ms": time_ms(select), "library_device_ms": device_ms(select),
                       **bound(n_bytes, 0)},
               "bwd": {"ms": time_ms(bwd), "device_ms": device_ms(bwd),
                       "cold_device_ms": device_ms(bwd, cold=True),
                       "plain_ms": time_ms(lambda: rs.rows_select_bwd_plain(g, idx, rows),
                                           PLAIN_RUNS),
                       "library_ms": time_ms(add), "library_device_ms": device_ms(add),
                       "library_repeats": torch.equal(*added),
                       "library_max_abs_diff": float((added[0] - want).abs().max()),
                       **bound(n_bytes, n * k)}}
        torch.use_deterministic_algorithms(True)
        try:
            det = [add(), add()]
            torch.cuda.synchronize()
            res["bwd"].update(deterministic_library_ms=time_ms(add),
                              deterministic_library_repeats=torch.equal(*det))
        except RuntimeError as e:
            res["bwd"].update(deterministic_library_ms=None,
                              deterministic_library_raises=str(e).splitlines()[0][:160])
        finally:
            torch.use_deterministic_algorithms(False)
    f, b = res["fwd"], res["bwd"]
    res["fwd"]["at_or_below_library"] = f["ms"] <= f["library_ms"]
    phase("kernels", f"rows_select {label}: N={n} R={rows} K={k}: K7 bit-equal to the plain "
          f"gather and index_select {fwd_same}, K7b bit-equal to its plain version on two "
          f"calls {bwd_same}; K7 call {f['ms']!r} ms (at or below index_select's "
          f"{f['at_or_below_library']}), device {f['device_ms']!r} ms (L2 cold "
          f"{f['cold_device_ms']!r}), plain {f['plain_ms']!r}, index_select call "
          f"{f['library_ms']!r} device {f['library_device_ms']!r}, bound {f['bound_ms']!r} ms "
          f"by {f['bound_by']}; K7b ({res['route']}) call "
          f"{b['ms']!r} ms, device {b['device_ms']!r} ms (L2 cold {b['cold_device_ms']!r}), "
          f"plain {b['plain_ms']!r}, index_add call {b['library_ms']!r} device "
          f"{b['library_device_ms']!r} (repeats its bits "
          f"{b['library_repeats']}, max |d| from K7b {b['library_max_abs_diff']!r}), "
          f"deterministic index_add "
          f"{b.get('deterministic_library_ms')!r} (repeats "
          f"{b.get('deterministic_library_repeats')}, raises "
          f"{b.get('deterministic_library_raises')!r}), bound {b['bound_ms']!r} ms by "
          f"{b['bound_by']}; segments by rows {res['segment_rows']}")
    if not (fwd_same and bwd_same):
        raise AssertionError(f"rows_select {label}: a kernel disagrees with its plain version")
    return res


def root_stats(args, motion) -> dict:
    """What the sphere kernel's inputs need, from the plain version's
    arithmetic up to delta: the (ray, sphere) pairs, and the pairs with
    delta > 0, the only ones that take the root."""
    (ox, oy, oz), (dx, dy, dz), (cx, cy, cz), r2, active = args
    n, s = ox.shape[0], r2.shape[0]
    r2s = torch.where(active, r2, torch.full_like(r2, -float("inf")))
    roots = 0
    step = 32768
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        ls = []
        for i, (o, c) in enumerate(zip((ox, oy, oz), (cx, cy, cz))):
            if motion:
                c = c + motion["speed_xyz"][i] * motion["time"][sl, None]
            ls.append(o[sl, None] - c)
        half_b = dx[sl, None] * ls[0] + dy[sl, None] * ls[1] + dz[sl, None] * ls[2]
        ok = half_b * half_b - (ls[0] * ls[0] + ls[1] * ls[1] + ls[2] * ls[2] - r2s) > 0.0
        roots += int(ok.sum())
    return {"pairs": n * s, "roots": roots}


def moving_bounce_rays(args, motion, t, idx, gen):
    """Case (e): from each primary hit of case (d) a cosine-weighted
    direction about the moved sphere's outward normal, from a seeded
    generator, with the ray's shutter time kept; the rays that missed are
    left out. -> (args, motion) of the sphere kernel."""
    o, d, c, r2, active = args
    hit = t < BIG
    i = idx.long()[hit]
    tm = motion["time"][hit].contiguous()
    p = torch.stack(o, 1)[hit] + torch.stack(d, 1)[hit] * t[hit, None]
    center = torch.stack(c, 1)[i] + torch.stack(motion["speed_xyz"], 1)[i] * tm[:, None]
    normal = (p - center) / r2[i].sqrt()[:, None]
    u = torch.randn(p.shape[0], 3, generator=gen, device=p.device)
    dirs = normal + u / u.norm(dim=1, keepdim=True)
    dirs = dirs / dirs.norm(dim=1, keepdim=True).clamp_min(1e-6)
    return (cols(p), cols(dirs), c, r2, active), {"speed_xyz": motion["speed_xyz"], "time": tm}


def warp_idle(work: torch.Tensor) -> float:
    """Idle share of the lanes of 32-ray warps (consecutive rays) that each
    run until their slowest ray is done: 1 - sum(work) / (32 * max per warp).
    A property of the rays in K6's layout of one ray a thread."""
    n = work.shape[0] // WARP * WARP
    w = work[:n].reshape(-1, WARP).to(torch.float64)
    busy = float(w.amax(dim=1).sum()) * WARP
    return 1.0 - float(w.sum()) / busy if busy else 0.0


CHAIN_RAYS = 32  # K6's chain floor: the rays with the most DE iterations, alone in one launch


def chain_floor(o3, d3, active, t_min, t_max, iterations: torch.Tensor, got) -> dict:
    """K6 on the CHAIN_RAYS rays with the most DE iterations (march plus
    normal), alone in one launch: their device ms (device_ms) and the ns a
    DE iteration of the longest of them. Their outputs must be those of
    the whole call."""
    from raysnail_tpu_torch.ops import mandelbulb_march as mm

    idx = torch.topk(iterations, min(CHAIN_RAYS, iterations.numel())).indices
    o, d = o3[:, idx].contiguous(), d3[:, idx].contiguous()
    act = None if active is None else active[idx].contiguous()
    call = lambda: mm.mandelbulb_march(o, d, t_min, t_max, act)
    with counts_kept():
        alone = call()
    if not all(torch.equal(a, b.index_select(-1, idx)) for a, b in zip(alone, got)):
        raise AssertionError("mandelbulb_march: the slowest rays alone differ from the call")
    ms = device_ms(call)
    longest = int(iterations.max())
    return {"chain_floor_ms": ms, "chain_ns_per_iteration": ms * 1e6 / max(longest, 1)}


def check_march_kernel(o3, d3, active, t_min, t_max, label: str) -> dict:
    """K6 against its plain version on the same rays: t, valid, normal, u, v
    and the step and iteration counts bit for bit. Times the kernel per call
    (CUDA events around the call, and device_ms), the plain version once,
    and the chain floor; reads the per-ray DE iterations (max, p99). -> the
    record's numbers and the outputs."""
    from raysnail_tpu_torch.ops import mandelbulb_march as mm

    call = lambda: mm.mandelbulb_march(o3, d3, t_min, t_max, active)
    with counts_kept():
        got = mm.mandelbulb_march(o3, d3, t_min, t_max, active, stats=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = mm.mandelbulb_march_plain(o3, d3, t_min, t_max, active, stats=True)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        names = ("t", "valid", "normal", "u", "v", "counts")
        differ = {k: int((a != b).sum()) for k, a, b in zip(names, got, want)
                  if not torch.equal(a, b)}
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        ms = time_ms(call)
        dev_ms = device_ms(call)
    t, valid, _, _, _, counts = got
    steps, march_iters, normal_iters = counts
    n = t.shape[0]
    live = steps > 0
    iterations = march_iters + normal_iters
    ops = mm.operations(counts, valid)
    out = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           **bound(n * mm.RAY_BYTES, ops), "issue_floor_ms": ops / FP32_NO_FMA * 1e3,
           **chain_floor(o3, d3, active, t_min, t_max, iterations, got[:5]),
           "rays": n, "hits": int(valid.sum()), "marched": int(live.sum()),
           "steps_mean": float(steps[live].float().mean()) if bool(live.any()) else 0.0,
           "steps_max": int(steps.max()),
           "iterations_per_step": float(march_iters.sum()) / max(int(steps.sum()), 1),
           "iterations_max": int(iterations.max()),
           "iterations_p99": float(torch.quantile(iterations[live].double(), 0.99))
           if bool(live.any()) else 0.0,
           "warp_idle_steps": warp_idle(steps),
           "warp_idle_iterations": warp_idle(iterations)}
    phase("kernels", f"mandelbulb_march {label}: N={n}, {out['marched']} marched, "
          f"{out['hits']} hits; outputs that differ from the plain version "
          f"{differ or 'none'} (max|d|={err!r}); steps per marched ray mean "
          f"{out['steps_mean']!r}, max {out['steps_max']}; DE iterations per step "
          f"{out['iterations_per_step']!r}; DE iterations a ray (march + normal) max "
          f"{out['iterations_max']}, p99 {out['iterations_p99']!r}; kernel {ms!r} ms a call "
          f"(median of {TIMING_RUNS}), {dev_ms!r} ms device time a call, plain {plain_ms!r} "
          f"ms (one call); chain floor ({CHAIN_RAYS} slowest rays alone) "
          f"{out['chain_floor_ms']!r} ms, {out['chain_ns_per_iteration']!r} ns a DE iteration "
          f"of the longest; bound "
          f"{out['bound_ms']!r} ms by {out['bound_by']} ({ops} operations), issue floor "
          f"without FMA {out['issue_floor_ms']!r} ms; warp idle share "
          f"{out['warp_idle_steps']!r} by steps, {out['warp_idle_iterations']!r} by DE "
          f"iterations")
    if differ:
        raise AssertionError(f"mandelbulb_march {label}: the kernel disagrees with the plain "
                             f"version in {differ}")
    return {**out, "outputs": got}


def bulb_primary_rays(camera, cfg, device, samples: int = 1):
    """The mandelbulb-passes4 frame's primary rays of samples 0..samples-1
    in 16x8 image-tile order, as its sample-step path makes them, one
    sample after another -> (3, N) origin and direction."""
    from raysnail_tpu_torch.camera import generate_rays
    from raysnail_tpu_torch.prelude import rng as prng
    from raysnail_tpu_torch.render import _tile_grid

    px, py, _ = _tile_grid(cfg)
    px, py = torch.as_tensor(px, device=device), torch.as_tensor(py, device=device)
    streams = prng.fast_streams(BULB_SEED, py.long() * cfg.width + px.long())
    o, d = [], []
    for sid in range(samples):
        ray = generate_rays(camera, px, py, torch.full_like(px, sid % cfg.sqrt_spp),
                            torch.full_like(py, sid // cfg.sqrt_spp), cfg.sqrt_spp, cfg.width,
                            cfg.height, prng.fold_all(streams, sid))
        o.append(torch.stack(tuple(ray.origin)))
        d.append(torch.stack(tuple(ray.direction)))
    return torch.cat(o, 1).contiguous(), torch.cat(d, 1).contiguous()


def bulb_bounce_rays(o3, d3, out, gen):
    """The primary rays' next rays, in place: from each hit point a
    cosine-weighted direction about the normal turned toward the ray, from
    a seeded generator; a ray that missed is a dead lane. -> (origin,
    direction, active)."""
    t, valid, normal = out[0], out[1], out[2]
    facing = (d3 * normal).sum(0) < 0.0
    nrm = torch.where(facing, normal, -normal)
    u = torch.randn(3, t.shape[0], generator=gen, device=t.device)
    d = nrm + u / u.norm(dim=0, keepdim=True)
    d = d / d.norm(dim=0, keepdim=True).clamp_min(1e-6)
    o = torch.where(valid, o3 + d3 * torch.where(valid, t, 0.0), o3)
    d = torch.where(valid, d, d3)
    return o.contiguous(), d.contiguous(), valid.clone()


@contextlib.contextmanager
def intersect_calls():
    """Count scene.intersect calls in the block (the integrator calls it
    once a shade iteration): -> a dict whose "n" holds the count."""
    from raysnail_tpu_torch import scene as scene_mod

    seen = {"n": 0}
    inner = scene_mod.intersect

    def counted(*args, **kwargs):
        seen["n"] += 1
        return inner(*args, **kwargs)

    scene_mod.intersect = counted
    try:
        yield seen
    finally:
        scene_mod.intersect = inner


def check_bvh_kernel(kind, args, t_min, t_max, label: str, time_it: bool):
    """bvh_traverse kernel vs its plain version on the same inputs: t and
    every attribute bit-equal, i.e. the same winner on every ray."""
    from raysnail_tpu_torch.ops import bvh_traverse as bt

    before = dict(bt.bvh_traverse.launches)
    t0 = time.perf_counter()
    out = bt.bvh_traverse(*args, t_min, t_max, kind=kind)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = {}
    ref = bt.bvh_traverse_plain(*args, t_min, t_max, kind=kind, stats=stats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err = float((out[0] - ref[0]).abs().max())
    same = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
    t, cap = out[0], args[2]
    n_hit = int((t < BIG).sum())
    dead_ok = bool((t[cap <= 0] == BIG).all()) and all(
        bool((a[cap <= 0] == 0).all()) for a in out[1:])
    res = {"max_abs_err": err, "equal": all(same), "hits": n_hit,
           **bvh_bound(kind, args[0][0].shape[0], n_hit, stats)}
    if time_it:
        res["ms"] = time_ms(lambda: bt.bvh_traverse(*args, t_min, t_max, kind=kind))
        res["plain_ms"] = time_ms(
            lambda: bt.bvh_traverse_plain(*args, t_min, t_max, kind=kind), PLAIN_RUNS)
    bt.bvh_traverse.launches = before  # comparison launches are not the main path's
    n = args[0][0].shape[0]
    phase("kernels", f"bvh_traverse {kind} {label}: N={n} B={args[5].shape[0]} blocks "
          f"M={args[3].shape[1]} nodes x{args[3].shape[0]} orders, hits={n_hit}, "
          f"dead={int((cap <= 0).sum())}, capped={int(((cap > 0) & (cap < BIG)).sum())}; "
          f"max|dt|={err!r}, outputs equal {same}, dead lanes ok {dead_ok}; first call "
          f"{t1 - t0:.3f} s, plain {t2 - t1:.3f} s; needed per ray: {stats}, bound "
          f"{res['bound_ms']!r} ms by {res['bound_by']}"
          + (f"; kernel {res['ms']!r} ms (median of {TIMING_RUNS}), plain "
             f"{res['plain_ms']!r} ms (median of {PLAIN_RUNS})" if time_it else ""))
    if not all(same) or err != 0.0 or not dead_ok or n_hit == 0:
        raise AssertionError(f"bvh_traverse {kind} {label}: kernel disagrees with the "
                             f"plain version (max|dt|={err}, equal={same}, dead ok "
                             f"{dead_ok}, hits {n_hit})")
    return res


MODES = ((False, False), (True, False), (False, True), (True, True))  # (stream, two_level)
# tri_mxu's t against tri's on rays that both hit: within MXU_RTOL on all but
# MXU_EDGE_SHARE of them (rays on a triangle's edge, where the two solvers'
# roundings of beta and gamma pick different triangles)
MXU_RTOL, MXU_EDGE_SHARE = 1e-3, 1e-3


def check_packet_kernel(kind, args, cut, t_min, t_max, label: str, time_it: bool):
    """The packet kernel of `kind` against its plain version (packet=True) on
    the same inputs: t and every attribute bit-equal; then stream and
    two_level, alone and together, bit-equal to the kernel with both off.
    -> {"stats", "plain_ms", "err", "ms": {(stream, two_level): ms}, "out"}."""
    from raysnail_tpu_torch.ops import bvh_traverse as bt

    before = dict(bt.bvh_traverse.launches)
    cbb, crange = cut
    call = lambda s, tl: bt.bvh_traverse(*args, t_min, t_max, kind=kind, packet=True,
                                         stream=s, two_level=tl, cbb=cbb, crange=crange)
    t0 = time.perf_counter()
    base = call(False, False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = {}
    ref = bt.bvh_traverse_plain(*args, t_min, t_max, kind=kind, packet=True, stats=stats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err = float((base[0] - ref[0]).abs().max())
    same = [bool(torch.equal(a, b)) for a, b in zip(base, ref)]
    t, cap = base[0], args[2]
    n_hit = int((t < BIG).sum())
    dead_ok = bool((t[cap <= 0] == BIG).all()) and all(
        bool((a[cap <= 0] == 0).all()) for a in base[1:])
    modes_same = {}
    for mode in MODES[1:]:
        out = call(*mode)
        torch.cuda.synchronize()
        modes_same[mode] = all(bool(torch.equal(a, b)) for a, b in zip(out, base))
    res = {"stats": stats, "plain_ms": (t2 - t1) * 1e3, "err": err, "ms": {}, "out": base,
           "hits": n_hit, **bvh_bound(kind, args[0][0].shape[0], n_hit, stats)}
    if time_it:
        for mode in MODES:
            res["ms"][mode] = time_ms(lambda: call(*mode))
    bt.bvh_traverse.launches = before  # comparison launches are not the main path's
    n = args[0][0].shape[0]
    phase("kernels", f"packet {kind} {label}: N={n} B={args[5].shape[0]} blocks "
          f"M={args[3].shape[1]} nodes x{args[3].shape[0]} orders, hits={n_hit}, "
          f"dead={int((cap <= 0).sum())}; vs plain max|dt|={err!r}, outputs equal {same}, "
          f"dead lanes ok {dead_ok}; (stream, two_level) modes bit-equal to mode-off: "
          f"{modes_same}; first call {t1 - t0:.3f} s, plain (one run) {t2 - t1:.3f} s; "
          f"needed per ray: {stats}, bound {res['bound_ms']!r} ms by {res['bound_by']}"
          + (f"; kernel ms by (stream, two_level), median of {TIMING_RUNS}: {res['ms']}"
             if time_it else ""))
    if not all(same) or err != 0.0 or not dead_ok or n_hit == 0 or not all(modes_same.values()):
        raise AssertionError(f"packet {kind} {label}: kernel disagrees (vs plain max|dt|="
                             f"{err}, equal={same}, dead ok {dead_ok}, hits {n_hit}, modes "
                             f"{modes_same})")
    return res


def random_rays(gen, n, lo, hi, device):
    """n rays with origins uniform in the box [lo, hi] and random unit
    directions; a finite t_cap on a third, dead lanes (t_cap -1) on a
    tenth, the rest uncapped."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    o = torch.rand(n, 3, generator=gen, device=device) * (hi - lo) + lo
    d = torch.randn(n, 3, generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True)
    cap = torch.full((n,), BIG, device=device)
    span = float((hi - lo).norm())
    cap[: n // 3] = torch.rand(n // 3, generator=gen, device=device) * span + 0.05
    cap[n // 3: n // 3 + n // 10] = -1.0
    return o, d, cap


def cols(a):
    return tuple(a[:, i].contiguous() for i in range(3))


def primary_rays(camera, width, height, sqrt_spp, device):
    """One frame of primary rays (sample 0) from `camera`, as the frame step
    makes them."""
    from raysnail_tpu_torch.camera import generate_rays
    from raysnail_tpu_torch.prelude import rng as prng

    n_pix = width * height
    p = torch.arange(n_pix, device=device)
    keys = prng.fold_all(prng.fast_streams(0, p), 0)
    zero = torch.zeros(n_pix, device=device)
    return generate_rays(camera, (p % width).float(), (p // width).float(), zero, zero,
                         sqrt_spp, width, height, keys)


def bounce_rays(scene, ray, cfg, gen):
    """The rays of a second shade iteration, from a seeded generator: from
    each primary ray's closest hit (the mesh through its traversal kernel,
    the spheres dense) a cosine-weighted direction about the normal; a ray
    that left the scene is a dead lane. -> (origin cols, direction cols,
    t_cap), t_cap the dense sphere group's hit as scene.intersect caps the
    mesh traversal."""
    from raysnail_tpu_torch import scene as scene_mod
    from raysnail_tpu_torch.camera import Ray
    from raysnail_tpu_torch.geometry import spheres as sphlib
    from raysnail_tpu_torch.prelude.vec import Vec3

    hit = scene_mod.intersect(scene, scene.arrays, ray, cfg.t_min, cfg.t_max,
                              routes=scene_mod.Routes(mesh_kernel=True))
    n = hit.t.shape[0]
    device = hit.t.device
    o = ray.origin.to_array() + ray.direction.to_array() * hit.t[:, None]
    u = torch.randn(n, 3, generator=gen, device=device)
    d = hit.normal.to_array() + u / u.norm(dim=1, keepdim=True)
    d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-6)
    o = torch.where(hit.valid[:, None], o, torch.zeros_like(o)).contiguous()
    d = torch.where(hit.valid[:, None], d, torch.ones_like(d) / 3 ** 0.5).contiguous()
    bounce = Ray(origin=Vec3(*cols(o)), direction=Vec3(*cols(d)), time=ray.time)
    cap = sphlib.intersect(scene.arrays.spheres, bounce, cfg.t_min, cfg.t_max).t
    cap = torch.where(hit.valid, cap, torch.full_like(cap, -1.0))
    return cols(o), cols(d), cap.contiguous()


def frame(scene, camera, cfg, seed, counters):
    """One timed frame through make_frame_step, with the launch counts of
    that run -> (image, seconds, iterations, {kernel: launches}, peak bytes)."""
    from raysnail_tpu_torch.prelude import color as colorlib
    from raysnail_tpu_torch.render import make_frame_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    accum, iterations = make_frame_step(scene, cfg)(scene.arrays, camera, seed)
    img = colorlib.into_color(accum, float(cfg.effective_samples), cfg.gamma)
    img = img.to_array().reshape(cfg.height, cfg.width, 3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters.read()
    img = img.cpu().numpy()
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3) \
            or img.std() < 0.01:
        raise AssertionError(f"image is not finite or is flat (std {img.std()})")
    return img, seconds, iterations, launches, torch.cuda.max_memory_allocated()


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def intersect_launches(run: dict, label: str, device):
    """cudaLaunchKernel calls of one scene.intersect call on a frame's
    primary rays, counted by torch.profiler: all of it, and without the CSG
    trees and the media (what they add to a shade iteration). `run` is one
    of csg_frames' runs."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from raysnail_tpu_torch import scene as scene_mod
    from raysnail_tpu_torch.prelude import rng as prng

    scene, cfg = run["scene"], run["cfg"]
    ray = primary_rays(run["cam"], cfg.width, cfg.height, cfg.sqrt_spp, device)
    keys = prng.fold_all(prng.fast_streams(run["seed"], torch.arange(
        cfg.width * cfg.height, device=device)), 0)
    out = {}
    bare = dataclasses.replace(scene, csg_trees=(), media=())
    for part, sc in (("all", scene), ("primitives", bare)):
        with counts_kept():
            scene_mod.intersect(sc, sc.arrays, ray, cfg.t_min, cfg.t_max, keys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                scene_mod.intersect(sc, sc.arrays, ray, cfg.t_min, cfg.t_max, keys)
                torch.cuda.synchronize()
        out[part] = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    phase("profile", f"{label}: one intersect call on its primary rays: {out['all']} "
          f"cudaLaunchKernel, {out['primitives']} without the trees and media "
          f"(+{out['all'] - out['primitives']})")


def csg_frames(device, card, counters) -> dict:
    """The CSG and media frames of CSG_FRAMES: each built through the user's
    entry points (the SDL driver, the scenes' builders), then one timed first
    frame (no warm-up) with its launch counts. book2's frame must launch the
    box kernel and K1's moving form in every shade iteration. -> {label:
    {scene, cam, cfg, seed, seconds, iterations, launches}}."""
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.scenes import book2, cornell
    from raysnail_tpu_torch.sdl.driver import build_scene

    runs = {}
    for label, source, w, h, spp, depth, seed in CSG_FRAMES:
        cfg = RenderConfig(width=w, height=h, samples=spp, max_depth=depth)
        t0 = time.perf_counter()
        if source.endswith(".sdl"):
            scene, cam = build_scene(os.path.join(ROOT, "sdl", source), cfg, device)
        elif source == "book2":
            scene = book2.all_feature_scene(7).compile(cfg.dtype, device)
            cam = book2.book2_camera(w, h, device=device)
        else:
            scene = cornell.cornell_box(smoke=True).compile(cfg.dtype, device)
            cam = cornell.cornell_camera(w, h, device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        img, seconds, iterations, launches, peak = frame(scene, cam, cfg, seed, counters)
        spp_eff = cfg.effective_samples
        per_iter = {k: round(v / iterations, 3) for k, v in nonzero(launches).items()}
        groups = [k for _, k in scene.csg_groups]
        phase("main", f"{label} {w}x{h}@{spp_eff}spp depth {depth}, first frame (no warm-up) "
              f"on {card}: {seconds!r} s, "
              f"{w * h * spp_eff / seconds / 1e6!r} Mprimary-rays/s, {iterations} shade "
              f"iterations, kernel launches {nonzero(launches)} ({per_iter} per iteration), "
              f"peak {peak} B allocated, scene set-up {setup:.3f} s; {scene.static.n_csg} CSG "
              f"trees in groups {groups}, {scene.static.n_media} media; image mean "
              f"{img.mean()!r}, std {img.std()!r}")
        if scene.arrays.spheres is not None and launches["sphere_min_t"] < iterations:
            raise AssertionError(f"{label}: the render did not go through sphere_min_t")
        runs[label] = dict(scene=scene, cam=cam, cfg=cfg, seed=seed, seconds=seconds,
                           iterations=iterations, launches=launches)
    b2 = runs["book2"]
    if (b2["launches"]["bvh_traverse/box"] < b2["iterations"]
            or b2["launches"]["sphere_min_t/moving"] < b2["iterations"]):
        raise AssertionError(f"book2's frame did not launch the box kernel and the moving "
                             f"sphere form every iteration: {nonzero(b2['launches'])}")
    return runs


class Counters:
    """Every kernel's launch count: reset to 0 before a run, read after."""

    def __init__(self):
        from raysnail_tpu_torch.ops import bvh_probes as bp
        from raysnail_tpu_torch.ops import bvh_traverse as bt
        from raysnail_tpu_torch.ops import mandelbulb_march as mm
        from raysnail_tpu_torch.ops import rows_select as rs
        from raysnail_tpu_torch.ops import sphere_min_t as smt
        self.smt, self.bt, self.bp = smt.sphere_min_t, bt.bvh_traverse, bp
        self.mm = mm.mandelbulb_march
        self.bwd = smt.sphere_min_t_bwd
        self.rs, self.rs_bwd = rs.rows_select, rs.rows_select_bwd

    def reset(self):
        self.smt.launches = self.smt.moving_launches = self.mm.launches = 0
        self.bwd.launches = self.bwd.moving_launches = 0
        self.rs.launches = self.rs_bwd.launches = 0
        self.bt.launches = {k: 0 for k in self.bt.launches}
        for k in self.bp.launches:
            self.bp.launches[k] = 0

    def read(self) -> dict:
        return {"sphere_min_t": self.smt.launches,
                "sphere_min_t/moving": self.smt.moving_launches,
                "sphere_min_t_bwd": self.bwd.launches,
                "sphere_min_t_bwd/moving": self.bwd.moving_launches,
                "mandelbulb_march": self.mm.launches,
                "rows_select": self.rs.launches,
                "rows_select_bwd": self.rs_bwd.launches,
                **{f"bvh_traverse/{k}": v for k, v in self.bt.launches.items()},
                **{f"probe/{k}": v for k, v in self.bp.launches.items()}}


def main() -> int:
    # 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "smoke run needs a CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels = run(torch.device("cuda", 0), card, profile="--profile" in sys.argv[1:])
    phase("done", f"all phases in {time.perf_counter() - t0:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def run(device: torch.device, card: str, profile: bool) -> list:
    """Phases 2-8 on `device`; -> the kernels' JSON records."""
    from raysnail_tpu_torch import cli, integrator, probes
    from raysnail_tpu_torch.accel.native import build as native
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.ops import _nvcc
    from raysnail_tpu_torch.ops import bvh_probes as bp
    from raysnail_tpu_torch.ops import bvh_traverse as bt
    from raysnail_tpu_torch.ops import mandelbulb_march as mm
    from raysnail_tpu_torch.ops import rows_select as rs
    from raysnail_tpu_torch.ops import sphere_min_t as smt
    from raysnail_tpu_torch.geometry import spheres as sphlib
    from raysnail_tpu_torch import render as render_mod
    from raysnail_tpu_torch import scene as scene_mod
    from raysnail_tpu_torch.render import render, render_passes
    from raysnail_tpu_torch.scene import SceneBuilder
    from raysnail_tpu_torch.scenes import book1
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.sdl.driver import build_scene
    from raysnail_tpu_torch.utils import golden

    # 2. build: one compiler process per source, all started together -----
    t0 = time.time()
    jobs = {"sphere_min_t.cu": lambda: smt.build(verbose=True),
            "bvh_traverse.cu": lambda: bt.build(verbose=True),
            "bvh_packet.cu": lambda: bt.build_packet(verbose=True),
            "bvh_probes.cu": lambda: bp.build(verbose=True),
            "mandelbulb_march.cu": lambda: mm.build(verbose=True),
            "rows_select.cu": lambda: rs.build(verbose=True),
            "bvh_builder.cpp": native.build}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        libs = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        phase("build", f"{name} -> {os.path.relpath(lib, ROOT)}")
    phase("build", f"all built in {time.time() - t0:.2f} s (nvcc {' '.join(_nvcc.NVCC_FLAGS)}; "
          f"g++ {' '.join(native.GXX_FLAGS)})")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for moving in (False, True):
        sh = smt.launch_shape(moving)
        blocks = -(-WIDTH * HEIGHT // (sh["threads"] * sh["rays"]))
        phase("build", f"sphere_min_t, {'moving' if moving else 'static'} form: "
              f"{sh['threads']} threads x {sh['rays']} rays a block, {sh['tile']}-sphere tiles; "
              f"{sh['blocks_per_sm']} blocks an SM at once ({sh['blocks_per_sm'] * sh['threads'] // 32}"
              f" of its 64 warps); {WIDTH * HEIGHT} rays: {blocks} blocks, "
              f"{blocks / (sh['blocks_per_sm'] * n_sm)!r} waves on {n_sm} SMs")

    counters = Counters()
    gen = torch.Generator(device=device).manual_seed(7)

    # 3. kernels vs plain --------------------------------------------------
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SAMPLES)
    scene, camera = build_scene(SCENE, cfg, device)
    sph = scene.arrays.spheres
    # (a) the main path's shape: example.sdl's spheres x one frame of
    # primary rays from its camera
    ray = primary_rays(camera, WIDTH, HEIGHT, cfg.sqrt_spp, device)
    args_a = ((ray.origin.x, ray.origin.y, ray.origin.z),
              (ray.direction.x, ray.direction.y, ray.direction.z),
              (sph.center.x, sph.center.y, sph.center.z),
              (sph.radius * sph.radius).contiguous(), sph.active)
    res_a, _ = check_sphere_kernel(args_a, cfg.t_min, cfg.t_max,
                                   "(a) example.sdl primary rays", time_it=True)
    res_b, _ = check_sphere_kernel(sphere_case(gen, 100_003, 478, device), cfg.t_min, BIG,
                                   "(b) 478 random spheres, ragged rays", time_it=True)
    # the static book 1 frame's shape: its 481 balls x one frame of primary rays
    vcfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SMALL_SPP)
    sscene = book1.balls_scene(7).compile(vcfg.dtype, device)
    ssph = sscene.arrays.spheres
    sray = primary_rays(book1.balls_camera(WIDTH, HEIGHT, device=device), WIDTH, HEIGHT,
                        vcfg.sqrt_spp, device)
    args_s = (tuple(sray.origin), tuple(sray.direction), tuple(ssph.center),
              (ssph.radius * ssph.radius).contiguous(), ssph.active)
    res_s, _ = check_sphere_kernel(args_s, vcfg.t_min, vcfg.t_max,
                                   "static book 1 primary rays", time_it=True)
    args_c = sphere_case(gen, 65_537, 256, device, duplicate=True)
    res_c, (t_c, i_c) = check_sphere_kernel(args_c, cfg.t_min, BIG, "(c) duplicated spheres",
                                            time_it=False)
    hit_c = t_c < BIG
    if int(hit_c.sum()) == 0 or bool((i_c[hit_c] % 2 == 1).any()):
        raise AssertionError("sphere_min_t (c): a tie did not go to the first index")
    phase("kernels", f"sphere_min_t (c): every tie went to the first copy "
          f"({int(hit_c.sum())} hits)")
    smt_err = max(r["max_abs_err"] for r in (res_a, res_b, res_c, res_s))
    # (d) the moving form at the moving book 1 frame's shape: its 478 balls
    # with their speeds x one frame of primary rays with their shutter times
    vscene = book1.balls_scene(7, need_speed=True).compile(vcfg.dtype, device)
    vcam = book1.balls_camera(WIDTH, HEIGHT, need_shutter=True, device=device)
    vsph = vscene.arrays.spheres
    vray = primary_rays(vcam, WIDTH, HEIGHT, vcfg.sqrt_spp, device)
    args_d = (tuple(vray.origin), tuple(vray.direction), tuple(vsph.center),
              (vsph.radius * vsph.radius).contiguous(), vsph.active)
    motion = {"speed_xyz": tuple(vsph.speed), "time": vray.time.contiguous()}
    res_d, (t_d, i_d) = check_sphere_kernel(args_d, vcfg.t_min, vcfg.t_max,
                                            "(d) moving book 1 primary rays, moving form",
                                            time_it=True, motion=motion)
    # (e) the rays of a second shade iteration of that frame
    args_e, motion_e = moving_bounce_rays(args_d, motion, t_d, i_d, gen)
    res_e, _ = check_sphere_kernel(args_e, vcfg.t_min, vcfg.t_max,
                                   "(e) moving book 1 bounce rays, moving form",
                                   time_it=True, motion=motion_e)
    t_still = smt.sphere_min_t(*args_d, vcfg.t_min, vcfg.t_max)[0]
    moved = int((t_still != t_d).sum())
    phase("kernels", f"sphere_min_t (d): the motion changes t on {moved} of {t_d.numel()} rays "
          f"(shutter times up to {float(vray.time.max())!r})")
    if not vscene.static.moving or vsph.pk_bb is not None or moved == 0:
        raise AssertionError("the moving book 1 scene does not move, or it was packed")

    # K7 and K7b (the rows' select and its fixed-order transpose)
    res_rows = {name: check_rows_select(idx, rows, k, gen, label) for name, (idx, rows, k, label)
                in rows_cases(scene, ray, cfg, sscene, sray, vcfg, gen).items()}

    # the Mandelbulb march (K6): the mandelbulb-passes4 camera's primary rays
    # in tile order, then their bounce rays in place
    bcfg = RenderConfig(width=BULB_W, height=BULB_H, samples=BULB_SPP, max_depth=BULB_DEPTH,
                        passes=BULB_PASSES)
    bulb_scene, bulb_cam = golden.mandelbulb_scene(bcfg, device)
    o_b, d_b = bulb_primary_rays(bulb_cam, bcfg, device)
    res_bulb = check_march_kernel(o_b, d_b, None, bcfg.t_min, bcfg.t_max,
                                  f"passes4 primary rays, {BULB_W}x{BULB_H} in tile order")
    ob2, db2, act2 = bulb_bounce_rays(o_b, d_b, res_bulb["outputs"], gen)
    res_bulb_b = check_march_kernel(ob2, db2, act2, bcfg.t_min, bcfg.t_max,
                                    "passes4 bounce rays (dead lanes where the primary missed)")
    if res_bulb["hits"] < BULB_W * BULB_H // 10 or res_bulb_b["marched"] == 0:
        raise AssertionError("the passes4 rays barely meet the bulb")
    # more rays than the card holds threads at once
    o_m, d_m = bulb_primary_rays(bulb_cam, bcfg, device, BULB_MANY_SAMPLES)
    res_bulb_m = check_march_kernel(o_m, d_m, None, bcfg.t_min, bcfg.t_max,
                                    f"passes4 primary rays of {BULB_MANY_SAMPLES} samples, "
                                    f"{o_m.shape[1]} in tile order")

    # bvh_traverse, kind "tri": the mesh-200k scene (its host compile is timed)
    mcfg = RenderConfig(width=MESH_W, height=MESH_H, samples=MESH_SPP, max_depth=MESH_DEPTH)
    t0 = time.perf_counter()
    mscene, mcam = golden.mesh_scene(mcfg, device, *KNOT_200K)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    tri = mscene.arrays.triangles
    phase("kernels", f"mesh-200k host compile {compile_s:.3f} s: "
          f"{int((tri.mat_id != -2).sum())} triangles, pk_bb {tuple(tri.pk_bb.shape)}, "
          f"pk_tri {tuple(tri.pk_tri.shape)}")
    pk_tri = (tri.pk_bb, tri.pk_links, tri.pk_tri)
    # (a) the main path's first traversal: one frame of primary rays, capped
    # by the dense sphere group's hits as scene.intersect caps them
    mray = primary_rays(mcam, MESH_W, MESH_H, mcfg.sqrt_spp, device)
    cap = sphlib.intersect(mscene.arrays.spheres, mray, mcfg.t_min, mcfg.t_max).t
    cases = {"tri": (cols(mray.origin.to_array()), cols(mray.direction.to_array()),
                     cap.contiguous(), *pk_tri)}
    res_tri = check_bvh_kernel("tri", cases["tri"], mcfg.t_min, mcfg.t_max,
                               "(a) mesh-200k primary rays, sphere-capped", time_it=True)
    # (c) the rays of a second shade iteration: where the walks diverge
    bounce = bounce_rays(mscene, mray, mcfg, gen)
    bounce_cases = {"tri": (*bounce, *pk_tri)}
    res_tri_bounce = check_bvh_kernel("tri", bounce_cases["tri"], mcfg.t_min, mcfg.t_max,
                                      "(c) mesh-200k bounce rays, sphere-capped", time_it=True)
    # (b) divergent rays from inside and around the knot's bounds
    root = tri.pk_bb[0, 0, :6]
    o, d, cap = random_rays(gen, 16_384, root[:3] - 1.0, root[3:] + 1.0, device)
    div_rays = (cols(o), cols(d), cap)
    check_bvh_kernel("tri", (*div_rays, *pk_tri), mcfg.t_min, mcfg.t_max,
                     "(b) divergent rays", time_it=False)

    # kind "box": the 144-box field of boxfield-kernel; a sixth of the rays
    # start inside box (0, 0)
    bscene = golden.golden_configs(device)["boxfield-kernel"]()[0]
    bx = bscene.arrays.boxes
    n_main = MESH_W * MESH_H  # the main path's ray count per traversal
    o, d, cap = random_rays(gen, n_main, (-8.0, 0.05, -8.0), (8.0, 6.0, 8.0), device)
    o[: n_main // 6] = torch.rand(n_main // 6, 3, generator=gen, device=device) * 0.8 - 5.9
    o[: n_main // 6, 1] = 0.05
    cases["box"] = (cols(o), cols(d), cap, bx.pk_bb, bx.pk_links, bx.pk_box)
    res_box = check_bvh_kernel("box", cases["box"], mcfg.t_min, mcfg.t_max,
                               "144-box field, inside starts", time_it=True)

    # kind "sphere": 8,192 random spheres (above SPHERE_BVH_AUTO_MIN)
    rng = np.random.default_rng(11)
    b = SceneBuilder()
    for c in rng.uniform(-20, 20, (8192, 3)):
        b.add(ir.Sphere(tuple(c), float(rng.uniform(0.2, 0.6)),
                        ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    sg = b.compile(device=device).arrays.spheres
    o, d, cap = random_rays(gen, n_main, (-25.0,) * 3, (25.0,) * 3, device)
    cases["sphere"] = (cols(o), cols(d), cap, sg.pk_bb, sg.pk_links, sg.pk_sph)
    res_sph = check_bvh_kernel("sphere", cases["sphere"], mcfg.t_min, mcfg.t_max,
                               "8,192 random spheres", time_it=True)

    # the packet kernel: every kind on the same cases, with stream and
    # two_level off and on; tri_mxu on the same mesh compiled in its format
    t0 = time.perf_counter()
    xscene, _ = golden.mesh_scene(mcfg, device, n_seg=KNOT_200K[0], n_ring=KNOT_200K[1],
                                  mesh_solver="mxu")
    torch.cuda.synchronize()
    xtri = xscene.arrays.triangles
    phase("kernels", f"mesh-200k host compile in the tri_mxu format "
          f"{time.perf_counter() - t0:.3f} s: pk_tri {tuple(xtri.pk_tri.shape)}")
    if not (torch.equal(xtri.pk_bb, tri.pk_bb) and torch.equal(xtri.pk_cbb, tri.pk_cbb)):
        raise AssertionError("the two mesh formats do not share one tree")
    cases["tri_mxu"] = (*cases["tri"][:3], xtri.pk_bb, xtri.pk_links, xtri.pk_tri)
    cuts = {"tri": (tri.pk_cbb, tri.pk_crange), "tri_mxu": (xtri.pk_cbb, xtri.pk_crange),
            "box": (bx.pk_cbb, bx.pk_crange), "sphere": (sg.pk_cbb, sg.pk_crange)}
    labels = {"tri": "mesh-200k primary rays", "tri_mxu": "mesh-200k primary rays",
              "box": "144-box field, inside starts", "sphere": "8,192 random spheres"}
    res_pkt = {k: check_packet_kernel(k, cases[k], cuts[k], mcfg.t_min, mcfg.t_max,
                                      labels[k], time_it=True) for k in cases}
    pk_mxu = (xtri.pk_bb, xtri.pk_links, xtri.pk_tri)
    for k, pk in (("tri", pk_tri), ("tri_mxu", pk_mxu)):
        check_packet_kernel(k, (*div_rays, *pk), cuts[k], mcfg.t_min, mcfg.t_max,
                            "divergent rays", time_it=False)
    bounce_cases["tri_mxu"] = (*bounce, *pk_mxu)
    res_pkt_bounce = {k: check_packet_kernel(k, bounce_cases[k], cuts[k], mcfg.t_min,
                                             mcfg.t_max, "mesh-200k bounce rays", time_it=True)
                      for k in bounce_cases}
    ta, tb = res_pkt["tri"]["out"][0], res_pkt["tri_mxu"]["out"][0]
    both = (ta < BIG) & (tb < BIG)
    rel = ((ta - tb).abs() / ta)[both]
    mxu_rel = float(rel[rel <= MXU_RTOL].max())
    mxu_edge = int((rel > MXU_RTOL).sum())
    mxu_mask = int(((ta < BIG) != (tb < BIG)).sum())
    # against the per-ray kernel: the same rules, another octant for some rays
    tr = bt.bvh_traverse(*cases["tri"], mcfg.t_min, mcfg.t_max, kind="tri", packet=False)[0]
    counters.reset()
    phase("kernels", f"tri_mxu vs tri, packet kernel, {int(both.sum())} rays that both hit: "
          f"max rel |dt| {mxu_rel!r} on all but {mxu_edge} edge rays (rel |dt| > {MXU_RTOL}; "
          f"at most {MXU_EDGE_SHARE} of them allowed), {mxu_mask} rays hit in one only; "
          f"packet tri vs per-ray tri: {int((ta != tr).sum())} of {ta.numel()} rays differ in t")
    if mxu_edge > MXU_EDGE_SHARE * int(both.sum()) or mxu_mask > MXU_EDGE_SHARE * ta.numel():
        raise AssertionError("tri_mxu disagrees with tri beyond its stated tolerance")

    # the traversal probes on their own case and on mesh-200k: probes.run
    # holds each against its plain version and raises on a disagreement
    probe_records, probe_cases, probe_plain = {}, {}, {}
    for case_name in probes.CASES:
        t0 = time.perf_counter()
        pcase = probe_cases[case_name] = probes.build_case(case_name, "cuda")
        probe_plain[case_name] = {}  # the plain versions' results, kept for phase 5
        ptri = pcase.tri
        phase("kernels", f"probes, case {case_name}: rays={pcase.n} nodes={ptri.pk_bb.shape[1]} "
              f"orders={ptri.pk_bb.shape[0]} blocks={ptri.pk_tri.shape[0]}, sweep-all sweeps "
              f"{pcase.sweep_blocks} blocks")
        probe_records[case_name] = probes.run(
            "all", pcase, out=lambda line, c=case_name: phase("kernels", f"probe {c} {line}"),
            plain=probe_plain[case_name])
        n_equal = sum(r["bit_equal"] for r in probe_records[case_name])
        phase("kernels", f"probes, case {case_name}: {len(probe_records[case_name])} probes "
              f"held against their plain versions, {n_equal} of them bit for bit in every "
              f"output, in {time.perf_counter() - t0:.2f} s")
        if len(probe_records[case_name]) != len(bp.launch_keys()):
            raise AssertionError("a probe was not run")
    if tuple(ptri.pk_bb.shape) != tuple(tri.pk_bb.shape):
        raise AssertionError("the probes' mesh-200k is not the render path's mesh-200k")
    counters.reset()

    # 4. golden anchors on the card ------------------------------------------
    ref = golden.load_golden()
    anchor_launches = {}
    for name in (*ANCHORS, *golden.forced_mode_configs(device)):
        counters.reset()
        res = golden.check_anchor(name, ref, device)
        anchor_launches[name] = counters.read()
        phase("golden", f"{name}: max|d thumb|={res['dthumb']!r} (<= {golden.THUMB_ATOL}), "
              f"max|d mean|={res['dmean']!r} (<= {golden.MEAN_ATOL}); launches "
              f"{nonzero(anchor_launches[name])}")
    for name in OPEN_ANCHORS:
        counters.reset()
        res = golden.anchor_drift(name, ref, device)
        anchor_launches[name] = counters.read()
        phase("golden", f"{name} (open fault, thumbnail not held): max|d thumb|="
              f"{res['dthumb']!r} with {res['blocks_beyond']} blocks beyond {golden.THUMB_ATOL}, "
              f"max|d mean|={res['dmean']!r} (<= {golden.MEAN_ATOL}); launches "
              f"{nonzero(anchor_launches[name])}")
        if res["dmean"] > golden.MEAN_ATOL:
            raise AssertionError(f"{name}: global mean drifted by {res['dmean']}")
    want = {"mesh": "bvh_traverse/tri", "mesh-binned": "bvh_traverse/tri",
            "boxfield-kernel": "bvh_traverse/box", "book1-spherebvh": "bvh_traverse/sphere",
            "book2": "bvh_traverse/box", "quadric.sdl": "sphere_min_t",
            "csg.sdl": "sphere_min_t", "mandelbulb": "mandelbulb_march",
            **{name: "bvh_traverse/" + name.split("/", 1)[1]
               for name in golden.forced_mode_configs(device)}}
    for name, key in want.items():
        if anchor_launches[name][key] == 0:
            raise AssertionError(f"anchor {name} did not launch {key}")
    if anchor_launches["book2"]["sphere_min_t/moving"] == 0:
        raise AssertionError("anchor book2 did not launch sphere_min_t's moving form")

    # 5. main paths ------------------------------------------------------------
    # the probes' entry point: every probe on the card's case, held against
    # the plain versions' results that phase 3 computed on the same case
    counters.reset()
    t0 = time.perf_counter()
    rc = probes.main(["all", "--case", "mesh-200k"], case=probe_cases["mesh-200k"],
                     plain=probe_plain["mesh-200k"])
    torch.cuda.synchronize()
    probe_launches = counters.read()
    phase("main", f"probes.main(all, mesh-200k) returned {rc} in "
          f"{time.perf_counter() - t0:.2f} s; launches "
          f"{ {k: v for k, v in probe_launches.items() if k.startswith('probe/')} }")
    if rc != 0 or any(probe_launches[f"probe/{k}"] == 0 for k in bp.launch_keys()):
        raise AssertionError("the probes' entry point did not launch every probe")

    argv = ["--scene", SCENE, "-w", str(WIDTH), "--height", str(HEIGHT),
            "--samples", str(SAMPLES), "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "example.png")
        t0 = time.time()
        rc = cli.main(argv + ["-o", png])  # warm-up, through the user's entry point
        if rc != 0 or not os.path.getsize(png):
            raise AssertionError(f"cli.main returned {rc} or wrote no PNG")
        phase("main", f"warm-up through cli.main in {time.time() - t0:.2f} s, wrote PNG")

    # the timed run: the same calls cli.main makes, keeping the iteration count
    scene, camera = build_scene(SCENE, cfg, device)
    img, seconds, iterations, launches, peak = frame(scene, camera, cfg, 0, counters)
    spp = cfg.effective_samples
    phase("main", f"example.sdl {WIDTH}x{HEIGHT}@{spp}spp on {card}: {seconds!r} s, "
          f"{WIDTH * HEIGHT * spp / seconds / 1e6!r} Mprimary-rays/s, {iterations} shade "
          f"iterations, launches {nonzero(launches)}, peak {peak} B allocated; image mean "
          f"{img.mean()!r}, std {img.std()!r}")
    chunks = spp // integrator.chunk_width(spp, cfg.chunk_cap)
    smt_launches = launches["sphere_min_t"]
    if smt_launches < iterations or iterations < chunks:
        raise AssertionError(f"sphere_min_t ran {smt_launches} times in {iterations} shade "
                             "iterations: the render did not go through the kernel")
    # the materials' select, the base color's and the checker's colors'
    k7_launches = launches["rows_select"]
    if k7_launches < 3 * iterations:
        raise AssertionError(f"rows_select ran {k7_launches} times in {iterations} shade "
                             "iterations: the bounce body did not select its rows with K7")

    # passes=2 through render_passes: the full frame step, then the noisy
    # pixels again through the tile-ordered sample step
    pcfg = cfg.replace(samples=PASSES_SAMPLES, passes=2)
    seen = []
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_passes(scene, camera, pcfg, seed=0,
                        progress=lambda done, total, im: seen.append((done, total)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters.read()
    first = render(scene, camera, pcfg, seed=0)
    redone = int((np.abs(img - first).max(axis=-1) > 0).sum())
    phase("main", f"example.sdl {WIDTH}x{HEIGHT}@{pcfg.effective_samples}spp passes=2 "
          f"through render_passes on {card}: {seconds!r} s, progress calls {seen}, "
          f"{redone} pixels changed by pass 2, launches {nonzero(launches)}; image mean "
          f"{img.mean()!r}, std {img.std()!r}")
    if (len(seen) != 2 or redone == 0 or not np.isfinite(img).all()
            or img.shape != (HEIGHT, WIDTH, 3)):
        raise AssertionError("render_passes(passes=2) did not run its second pass")

    # the dense-primitive modules: transforms.sdl (a quadric, an oriented
    # box) and book 1 with moving balls (sphere_min_t's moving form)
    tcfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SMALL_SPP)
    tscene, tcam = build_scene(TRANSFORMS, tcfg, device)
    small = {"transforms.sdl": (tscene, tcam, tcfg), "book 1, moving balls": (vscene, vcam, vcfg)}
    small_launches = {}
    for label, (sc, cam_, run_cfg) in small.items():
        render(sc, cam_, run_cfg.replace(samples=4), seed=0)  # warm-up
        img, seconds, iterations, launches, peak = frame(sc, cam_, run_cfg, 0, counters)
        small_launches[label] = launches
        a = sc.arrays
        phase("main", f"{label} {WIDTH}x{HEIGHT}@{run_cfg.effective_samples}spp on {card}: "
              f"{seconds!r} s, "
              f"{WIDTH * HEIGHT * run_cfg.effective_samples / seconds / 1e6!r} Mprimary-rays/s, "
              f"{iterations} shade iterations, launches {nonzero(launches)}, peak {peak} B; "
              f"groups: spheres {0 if a.spheres is None else a.spheres.radius.shape[0]}, boxes "
              f"{0 if a.boxes is None else a.boxes.mat_id.shape[0]}, quadrics "
              f"{0 if a.quadrics is None else a.quadrics.qa.shape[0]}; image mean "
              f"{img.mean()!r}, std {img.std()!r}")
        if launches["sphere_min_t"] < iterations:
            raise AssertionError(f"{label}: the render did not go through sphere_min_t")
    if tscene.arrays.quadrics is None:
        raise AssertionError("transforms.sdl's ellipsoid did not lower to a quadric")
    moving_launches = small_launches["book 1, moving balls"]["sphere_min_t/moving"]
    if moving_launches == 0 or small_launches["transforms.sdl"]["sphere_min_t/moving"] != 0:
        raise AssertionError("the moving form ran in the wrong frame")

    # mesh-200k at full size: a warm-up frame through render(), then one
    # timed frame per configuration, per-ray and packet kernels side by side
    t0 = time.perf_counter()
    render(mscene, mcam, mcfg, seed=MESH_SEED)
    torch.cuda.synchronize()
    phase("main", f"mesh-200k warm-up frame through render() in "
          f"{time.perf_counter() - t0:.3f} s")
    packet_cfg = mcfg.replace(mesh_bin="never", bvh_packet="force")
    # (scene, config, the traversal's call-time switches as
    # golden.traversal_env sets them, the launch key the frame must count)
    mesh_cfgs = {
        "per-ray, entry binning": (mscene, mcfg, {}, "bvh_traverse/tri"),
        "per-ray": (mscene, mcfg.replace(mesh_bin="never"), {}, "bvh_traverse/tri"),
        "packet tri": (mscene, packet_cfg, {}, "bvh_traverse/packet/tri"),
        "packet tri, two_level": (mscene, packet_cfg, {"two_level": True},
                                  "bvh_traverse/packet/tri+two_level"),
        # the tri_mxu blocks of this mesh (93.6 MB) are above the stream
        # threshold, so the auto rule streams them: the resident read is forced
        "packet tri_mxu": (xscene, packet_cfg, {"stream": False},
                           "bvh_traverse/packet/tri_mxu"),
        "packet tri_mxu, stream": (xscene, packet_cfg, {},
                                   "bvh_traverse/packet/tri_mxu+stream"),
    }
    mesh_runs = {}
    for label, (sc, run_cfg, env, key) in mesh_cfgs.items():
        with golden.traversal_env(**env):
            img, seconds, iterations, launches, peak = frame(sc, mcam, run_cfg, MESH_SEED,
                                                             counters)
        mesh_runs[label] = (seconds, iterations, launches, img)
        phase("main", f"mesh-200k {MESH_W}x{MESH_H}@{MESH_SPP}spp depth {MESH_DEPTH}, "
              f"{label} on {card}: {seconds!r} s, "
              f"{MESH_W * MESH_H * MESH_SPP / seconds / 1e6!r} Mprimary-rays/s, "
              f"{iterations} shade iterations, launches {nonzero(launches)}, peak {peak} B "
              f"allocated, host compile {compile_s!r} s; image mean {img.mean()!r}, "
              f"std {img.std()!r}")
        if launches[key] < iterations or launches["sphere_min_t"] < iterations:
            raise AssertionError(f"mesh-200k, {label}: {nonzero(launches)} in {iterations} "
                                 "shade iterations: the render did not go through the kernels")
    tri_launches = mesh_runs["per-ray, entry binning"][2]["bvh_traverse/tri"]

    # the sample-step path: the same frame through render_sums in tile order
    px, py, inv = render_mod._tile_grid(packet_cfg)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = render_mod.render_sums(mscene, mcam, packet_cfg, MESH_SEED, px, py)
    img = render_mod._to_image(sums, packet_cfg)[inv].reshape(MESH_H, MESH_W, 3)
    seconds = time.perf_counter() - t0
    launches = counters.read()
    d_img = float(np.abs(img - mesh_runs["packet tri"][3]).max())
    phase("main", f"mesh-200k through render_sums in tile order (packet tri) on {card}: "
          f"{seconds!r} s, {MESH_W * MESH_H * MESH_SPP / seconds / 1e6!r} Mprimary-rays/s, "
          f"launches {nonzero(launches)}; max |d image| against the frame step "
          f"{d_img!r} (<= {SUMS_ATOL})")
    if d_img > SUMS_ATOL or launches["bvh_traverse/packet/tri"] == 0:
        raise AssertionError("render_sums disagrees with the frame step")

    # mesh-800k: leaf blocks above the stream threshold; 18,487 nodes, which
    # the port's node cap gives the 8 octant orders and the JAX package's cap
    # one order. The frame on each tree, and the one-order tree held against
    # the plain version (the K = 1 walk)
    def compile_800k(cap):
        cap0, scene_mod.OCTANT_CAP = scene_mod.OCTANT_CAP, cap
        try:
            t0 = time.perf_counter()
            sc, cam_ = golden.mesh_scene(mcfg, device, *KNOT_800K)
            torch.cuda.synchronize()
            return sc, cam_, time.perf_counter() - t0
        finally:
            scene_mod.OCTANT_CAP = cap0

    runs8 = {}
    for label, cap, orders in (("8 octant orders", scene_mod.OCTANT_CAP, 8),
                               ("one node order", SINGLE_ORDER_CAP, 1)):
        sc8, bcam8, compile8 = compile_800k(cap)
        tri8 = sc8.arrays.triangles
        leaf_bytes = tri8.pk_tri.numel() * 4
        if tri8.pk_bb.shape[0] != orders:
            raise AssertionError(f"mesh-800k's tree has {tri8.pk_bb.shape[0]} node orders, "
                                 f"not {orders}")
        img, seconds, iterations, launches, peak = frame(sc8, bcam8, mcfg, MESH_SEED, counters)
        runs8[label] = (sc8, seconds, launches)
        phase("main", f"mesh-800k, {label} ({int((tri8.mat_id != -2).sum())} triangles, pk_bb "
              f"{tuple(tri8.pk_bb.shape)}, leaf blocks {leaf_bytes} B > "
              f"{bt.stream_bytes()} B) {MESH_W}x{MESH_H}@{MESH_SPP}spp depth {MESH_DEPTH}, "
              f"first frame on {card}: {seconds!r} s, "
              f"{MESH_W * MESH_H * MESH_SPP / seconds / 1e6!r} Mprimary-rays/s, {iterations} "
              f"shade iterations, launches {nonzero(launches)}, peak {peak} B allocated, host "
              f"compile {compile8!r} s; image mean {img.mean()!r}, std {img.std()!r}")
        if (leaf_bytes <= bt.stream_bytes()
                or launches["bvh_traverse/packet/tri+stream"] < iterations):
            raise AssertionError("mesh-800k did not take the streamed packet kernel by the "
                                 "auto rule")
    stream_launches = runs8["8 octant orders"][2]["bvh_traverse/packet/tri+stream"]
    bscene8 = runs8["8 octant orders"][0]
    # the packet kernel on the one-order tree (18,487 nodes, streamed leaves)
    # against the plain version: 8,192 of its primary rays, 64 whole packets
    # spread over the frame, some dead and some capped
    ray8 = primary_rays(bcam8, MESH_W, MESH_H, mcfg.sqrt_spp, device)
    o8, d8 = ray8.origin.to_array(), ray8.direction.to_array()
    pick = (torch.arange(64, device=device)[:, None] * (MESH_W * MESH_H // 64)
            + torch.arange(bt.PACKET, device=device)[None, :]).reshape(-1)
    cap8 = torch.full((pick.numel(),), BIG, device=device)
    cap8[::3] = torch.rand(cap8[::3].numel(), generator=gen, device=device) * 6.0 + 0.5
    cap8[5::10] = -1.0
    res8 = check_packet_kernel("tri", (cols(o8[pick]), cols(d8[pick]), cap8, tri8.pk_bb,
                                       tri8.pk_links, tri8.pk_tri),
                               (tri8.pk_cbb, tri8.pk_crange), mcfg.t_min, mcfg.t_max,
                               "mesh-800k primary rays, one node order", time_it=False)
    if res8["hits"] < 100:
        raise AssertionError(f"mesh-800k check: only {res8['hits']} rays hit")
    # one call of all its primary rays: streamed against the resident read,
    # on the trees whose frame ran
    uncapped = torch.full((MESH_W * MESH_H,), BIG, device=device)
    for label, (sc8, _, _) in runs8.items():
        t8 = sc8.arrays.triangles
        args8 = (cols(o8), cols(d8), uncapped, t8.pk_bb, t8.pk_links, t8.pk_tri)
        call8 = lambda st: bt.bvh_traverse(*args8, mcfg.t_min, mcfg.t_max, kind="tri",
                                           packet=True, stream=st)
        same8 = all(bool(torch.equal(a, b)) for a, b in zip(call8(True), call8(False)))
        ms8 = {st: time_ms(lambda: call8(st)) for st in (True, False)}
        per_ray8 = time_ms(lambda: bt.bvh_traverse(*args8, mcfg.t_min, mcfg.t_max, kind="tri",
                                                   packet=False, stream=False))
        phase("main", f"mesh-800k primary rays, {label}, packet tri: stream {ms8[True]!r} ms, "
              f"resident read {ms8[False]!r} ms per call; per-ray kernel {per_ray8!r} ms "
              f"(medians of {TIMING_RUNS}), streamed and resident outputs equal {same8}")
        if not same8:
            raise AssertionError("mesh-800k: the streamed call differs from the resident one")
    counters.reset()

    t0 = time.perf_counter()
    ascene, acam = golden.mesh_scene(mcfg, device, *KNOT_AREA)
    torch.cuda.synchronize()
    acompile = time.perf_counter() - t0
    img, seconds, iterations, launches, peak = frame(ascene, acam, mcfg, MESH_SEED, counters)
    phase("main", f"mesh+arealight (9,600 triangles) {MESH_W}x{MESH_H}@{MESH_SPP}spp, "
          f"first frame (no warm-up) on {card}: {seconds!r} s, "
          f"{MESH_W * MESH_H * MESH_SPP / seconds / 1e6!r} Mprimary-rays/s, {iterations} "
          f"shade iterations, launches {nonzero(launches)}, peak {peak} B, host compile "
          f"{acompile!r} s; image mean {img.mean()!r}, std {img.std()!r}")
    if launches["bvh_traverse/tri"] < iterations:
        raise AssertionError("mesh+arealight did not go through the traversal kernel")

    # CSG and media: five frames through the user's entry points
    csg_runs = csg_frames(device, card, counters)
    book2_launches = csg_runs["book2"]["launches"]

    # mandelbulb-passes4 through render_passes, as bench.py times it: a first
    # pass over every pixel and three sparse passes, all on the sample-step
    # path in tile order (make_frame_step is None for a Mandelbulb)
    passes_seen = []
    counters.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with intersect_calls() as calls:
        img = render_passes(bulb_scene, bulb_cam, bcfg, seed=BULB_SEED,
                            progress=lambda done, total, im: passes_seen.append(done))
        torch.cuda.synchronize()
    bulb_seconds = time.perf_counter() - t0
    bulb_launches = counters.read()
    bulb_peak = torch.cuda.max_memory_allocated()
    bulb_rays = BULB_W * BULB_H * bcfg.effective_samples * BULB_PASSES
    phase("main", f"mandelbulb-passes4 {BULB_W}x{BULB_H}@{bcfg.effective_samples}spp depth "
          f"{BULB_DEPTH}, passes {BULB_PASSES}, first frame (no warm-up) on {card}: "
          f"{bulb_seconds!r} s, {bulb_rays / bulb_seconds / 1e6!r} Mprimary-rays/s (every pass "
          f"counted as a full frame of primary rays, as bench.py counts them), progress "
          f"{passes_seen}, {calls['n']} intersect calls, launches {nonzero(bulb_launches)}, "
          f"peak {bulb_peak} B allocated; image mean {img.mean()!r}, std {img.std()!r}")
    if (bulb_launches["mandelbulb_march"] != calls["n"] or calls["n"] == 0
            or bulb_launches["sphere_min_t"] != calls["n"]):
        raise AssertionError("mandelbulb-passes4: K6 and K1 did not run once an intersect call")
    if not np.isfinite(img).all() or img.shape != (BULB_H, BULB_W, 3) or img.std() < 0.01:
        raise AssertionError(f"mandelbulb-passes4: image not finite or flat (std {img.std()})")

    # the scan integrator at a small size: path_regen="never" and threefry,
    # against the default frame (the shuffled regeneration) of the same size
    scfg = RenderConfig(width=SCAN_W, height=SCAN_H, samples=SCAN_SPP)
    sc_scene, sc_cam = build_scene(SCENE, scfg, device)
    base = render(sc_scene, sc_cam, scfg, seed=0)
    scan_launches = {}
    for label, setting in (("path_regen='never'", {"path_regen": "never"}),
                           ("rng='threefry'", {"rng": "threefry"})):
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(sc_scene, sc_cam, scfg.replace(**setting), seed=0)
        seconds = time.perf_counter() - t0
        scan_launches[label] = launches = counters.read()
        dmean = float(np.abs(img.mean(axis=(0, 1)) - base.mean(axis=(0, 1))).max())
        phase("main", f"example.sdl {SCAN_W}x{SCAN_H}@{scfg.effective_samples}spp, {label} "
              f"(the scan integrator) on {card}: {seconds!r} s, "
              f"{SCAN_W * SCAN_H * scfg.effective_samples / seconds / 1e6!r} Mprimary-rays/s, "
              f"launches {nonzero(launches)}; channel means {img.mean(axis=(0, 1)).tolist()}, "
              f"max |d mean| against the default frame {dmean!r} (<= {SCAN_MEAN_ATOL})")
        if (launches["sphere_min_t"] < scfg.effective_samples * scfg.max_depth
                or not np.isfinite(img).all() or dmean > SCAN_MEAN_ATOL):
            raise AssertionError(f"the {label} frame did not go through K1 or is off")

    # 6. train: the gradient train step ---------------------------------------
    train = train_phase(device, card, counters, gen, {
        "(a) example.sdl primary rays": (args_a, {}),
        "static book 1 primary rays": (args_s, {}),
        "(d) moving book 1 primary rays, moving form": (args_d, motion)}, vcfg.t_min, vcfg.t_max)

    # 7. sharded: the port's sharding in a one-rank NCCL group ----------------
    sharded = sharded_phase(device, card, counters)

    if profile:
        smt_cases = {"(a) example.sdl primary rays": (args_a, {}),
                     "static book 1 primary rays": (args_s, {}),
                     "(d) moving book 1 primary rays": (args_d, motion),
                     "(e) moving book 1 bounce rays": (args_e, motion_e)}
        for label, (args, mo) in smt_cases.items():
            ms = device_ms(lambda: smt.sphere_min_t(*args, vcfg.t_min, vcfg.t_max, **mo))
            phase("profile", f"sphere_min_t {label}: {ms!r} ms device time per call "
                  f"({TIMING_RUNS} back to back)")
        wall = frame(vscene, vcam, vcfg, 0, counters)[1]
        profile_frame(vscene, vcam, vcfg, "book 1, moving balls", wall, seed=0,
                      kernel=("sphere_min_t_kernel<true>",), kernel_name="sphere_min_t (moving)")
        sphere_crossover(gen, device)
        profile_kernels(cases, mcfg.t_min, mcfg.t_max, "primary rays")
        profile_kernels(bounce_cases, mcfg.t_min, mcfg.t_max, "bounce rays")
        for label, (sc, run_cfg, env, _) in mesh_cfgs.items():
            with golden.traversal_env(**env):
                profile_frame(sc, mcam, run_cfg, f"mesh-200k, {label}", mesh_runs[label][0])
        for label, (sc8, sec8, _) in runs8.items():
            profile_frame(sc8, bcam8, mcfg, f"mesh-800k, {label}", sec8)
        ucfg = mcfg.replace(mesh_bin="never")
        _, useconds, _, _, _ = frame(bscene8, bcam8, ucfg, MESH_SEED, counters)
        profile_frame(bscene8, bcam8, ucfg, "mesh-800k, 8 octant orders, unbinned", useconds)
        for label, r in csg_runs.items():
            profile_frame(r["scene"], r["cam"], r["cfg"], label, r["seconds"], seed=r["seed"],
                          kernel=("sphere_min_t_kernel", "bvh_traverse_kernel"),
                          kernel_name="K1 and K3")
            intersect_launches(r, label, device)
        first = bcfg.replace(passes=1)
        t0 = time.perf_counter()
        render(bulb_scene, bulb_cam, first, seed=BULB_SEED)
        torch.cuda.synchronize()
        profile_frame(bulb_scene, bulb_cam, first, "mandelbulb-passes4, first pass",
                      time.perf_counter() - t0, kernel=("mandelbulb_march_kernel",),
                      kernel_name="K6",
                      run=lambda: render(bulb_scene, bulb_cam, first, seed=BULB_SEED))

    # the kernels' records: `launches` from a main-path run (a frame where one
    # runs the kernel or mode, else its forced anchor render)
    src = "raysnail_tpu_torch/csrc/"
    tpu = "raysnail_tpu/ops/bvh_pallas.py:"
    # case (a) for the static form and (d) for the moving one, with (b), the
    # static book 1 rays and the bounce case (e) beside them; each with its
    # bound and its issue floor without FMA
    smt_keys = ("bound_ms", "bound_by", "issue_floor_ms")
    records = [
        {"name": "sphere_min_t", "route": "cuda", "source": src + "sphere_min_t.cu",
         "replaces": "raysnail_tpu/ops/sphere_pallas.py:30",
         "launches": smt_launches, "max_abs_err": smt_err,
         "ms": res_a["ms"], "plain_ms": res_a["plain_ms"], **{k: res_a[k] for k in smt_keys},
         "b_ms": res_b["ms"], "b_bound_ms": res_b["bound_ms"],
         "book1_ms": res_s["ms"], "book1_bound_ms": res_s["bound_ms"],
         "book1_issue_floor_ms": res_s["issue_floor_ms"]},
        {"name": "sphere_min_t/moving", "route": "cuda", "source": src + "sphere_min_t.cu",
         "replaces": "raysnail_tpu/geometry/spheres.py:38",
         "launches": moving_launches, "max_abs_err": max(res_d["max_abs_err"],
                                                         res_e["max_abs_err"]),
         "ms": res_d["ms"], "plain_ms": res_d["plain_ms"], **{k: res_d[k] for k in smt_keys},
         "bounce_ms": res_e["ms"], "bounce_bound_ms": res_e["bound_ms"],
         "bounce_issue_floor_ms": res_e["issue_floor_ms"]}]
    bulb_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "issue_floor_ms",
                 "chain_floor_ms", "chain_ns_per_iteration", "steps_mean", "steps_max",
                 "iterations_per_step", "iterations_max", "iterations_p99",
                 "warp_idle_steps", "warp_idle_iterations")
    records.append({"name": "mandelbulb_march", "route": "cuda",
                    "source": src + "mandelbulb_march.cu",
                    "replaces": "raysnail_tpu/geometry/mandelbulb.py:159",
                    "launches": bulb_launches["mandelbulb_march"],
                    "max_abs_err": max(r["max_abs_err"] for r in (res_bulb, res_bulb_b,
                                                                  res_bulb_m)),
                    **{k: res_bulb[k] for k in bulb_keys},
                    **{f"bounce_{k}": res_bulb_b[k] for k in bulb_keys if k != "bound_by"},
                    **{f"samples4_{k}": res_bulb_m[k] for k in bulb_keys if k != "bound_by"}})
    per_ray = {"tri": (res_tri, tri_launches),
               "box": (res_box, book2_launches["bvh_traverse/box"]),
               "sphere": (res_sph, anchor_launches["book1-spherebvh"]["bvh_traverse/sphere"])}
    for k, (res, n_launch) in per_ray.items():
        records.append({"name": f"bvh_traverse/{k}", "route": "cuda",
                        "source": src + "bvh_traverse.cu", "replaces": tpu + "94",
                        "launches": n_launch, "max_abs_err": res["max_abs_err"],
                        "ms": res["ms"], "plain_ms": res["plain_ms"],
                        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"]})
        if k == "tri":  # its time on the bounce rays, beside its bound there
            records[-1].update(bounce_ms=res_tri_bounce["ms"],
                               bounce_bound_ms=res_tri_bounce["bound_ms"])
    frame_launches = {label: run[2] for label, run in mesh_runs.items()}
    frame_launches["mesh-800k"] = {"bvh_traverse/packet/tri+stream": stream_launches}
    for k, res in res_pkt.items():
        for stream, two_level in MODES:
            key = "bvh_traverse/" + bt.launch_key(k, True, stream, two_level)
            in_frames = max(run.get(key, 0) for run in frame_launches.values())
            anchor = f"{golden.PACKET_ANCHORS[k]}/{key.split('/', 1)[1]}"
            line = "413" if two_level else "519" if stream else "235" if k == "tri_mxu" else "94"
            records.append({"name": key, "route": "cuda", "source": src + "bvh_packet.cu",
                            "replaces": tpu + line,
                            "launches": in_frames or anchor_launches[anchor][key],
                            "max_abs_err": res["err"], "ms": res["ms"][(stream, two_level)],
                            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                            "bound_by": res["bound_by"]})
            if k in res_pkt_bounce:
                records[-1].update(bounce_ms=res_pkt_bounce[k]["ms"][(stream, two_level)],
                                   bounce_bound_ms=res_pkt_bounce[k]["bound_ms"])
    # the probes, at the entry point's case (mesh-200k): the TPU probe each
    # replaces, by the line of its pallas_call
    ab, lat = "scripts/kern_ab.py:", "scripts/kern_lat.py:"
    replaces = {"io/soa": ab + "170", "io/rows": ab + "196", "io/transpose": ab + "216",
                "io/packed": ab + "249", "walk": ab + "178", "sweep": ab + "174",
                "latency/w32": lat + "84", "latency/w128": lat + "84",
                "latency/w1024": lat + "84", "latency/cap": lat + "185",
                "latency/buf": lat + "185", "variant": "scripts/kern_walkvar.py:259"}
    for rec in probe_records["mesh-200k"]:
        key = rec["launch_key"]
        records.append({"name": f"probe/{key}", "route": "cuda", "source": src + "bvh_probes.cu",
                        "replaces": replaces.get(key) or replaces[key.split("/")[0]],
                        "launches": probe_launches[f"probe/{key}"],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], **bound(rec["bytes"], rec["flops"]),
                        # per launch over probes.LATENCY_REPS launches back to back
                        "ms_back_to_back": rec["ms_back_to_back"]})
    k1b = train["cases"]
    a, book1_s, moving = (k1b[k] for k in k1b)
    records.append({"name": "sphere_min_t_bwd", "route": "cuda", "source": src + "sphere_min_t.cu",
                    "replaces": "raysnail_tpu/geometry/spheres.py:38",
                    "launches": train["metal"]["launches"]["sphere_min_t_bwd"],
                    "max_abs_err": max(r["max_abs_err"] for r in k1b.values()),
                    **{k: a[k] for k in ("ms", "device_ms", "cold_device_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                    **{f"book1_{k}": book1_s[k] for k in ("ms", "device_ms", "cold_device_ms",
                                                          "bound_ms")},
                    **{f"moving_{k}": moving[k] for k in ("ms", "device_ms", "cold_device_ms",
                                                           "plain_ms", "bound_ms")},
                    "canonical_step_launches": train["canonical"]["launches"]["sphere_min_t_bwd"],
                    # in place: the metal cell's backward pass (torch.profiler)
                    **{f"in_place_{k}": train["metal_bwd"]["K1b"][k]
                       for k in ("launches", "device_ms", "ms_a_launch", "bound_ms",
                                 "half_of_bound")}})
    # K7 and K7b at example.sdl's material rows (K = 4), with book 1's rows,
    # 1,024 and 4,096 beside them; K7's launches in the canonical frame, K7b's
    # in the canonical train step, and each one's in one of its cells
    cell = train["cell_launches"]
    for key, name, launches, line in (
            ("fwd", "rows_select", k7_launches, "102"),
            ("bwd", "rows_select_bwd", train["canonical"]["launches"]["rows_select_bwd"], "102")):
        ex = res_rows["example.sdl"][key]
        records.append({
            "name": name, "route": "cuda", "source": src + "rows_select.cu",
            "replaces": "raysnail_tpu/geometry/hit.py:" + line, "launches": launches,
            "launches_a_cell": cell[name],
            "max_abs_err": max(r["max_abs_err"] for r in res_rows.values()),
            **{k: ex[k] for k in ("ms", "device_ms", "cold_device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
            "library_device_ms": ex["library_device_ms"],
            **{f"{case}_{k}": r[key][k] for case, r in res_rows.items() if case != "example.sdl"
               for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                         "library_device_ms")},
            **({"deterministic_library_ms": ex.get("deterministic_library_ms"),
                "library_repeats": ex["library_repeats"],
                "in_place_canonical_device_ms": train["canonical_bwd"]["K7b"]["device_ms"],
                "in_place_canonical_launches": train["canonical_bwd"]["K7b"]["launches"]}
               if key == "bwd" else {})})
    # the sharded phase's launches: K1 in the frame step, K2 in the forced mesh check
    records[0]["sharded_frame_launches"] = sharded["frame"]["sphere_min_t"]
    next(r for r in records if r["name"] == "bvh_traverse/tri")["sharded_mesh_launches"] = \
        sharded["k2"]
    for rec in records:
        # none but K7's and K7b's: no single PyTorch call computes the others
        rec.setdefault("library_ms", None)
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was launched by no main-path run")
    return records



def check_bwd_kernel(args, motion, t_min, t_max, gen, label: str) -> dict:
    """K1b against its plain version on K1's output for `args` and a seeded
    cotangent: the six gradients bit for bit; call, device and plain ms and
    the bound (per ray t, and the two gradients; per ray that hit o, d, idx,
    g_t, and time when moving; each sphere once)."""
    from raysnail_tpu_torch.ops import sphere_min_t as smt

    o, d, c, r2, active = args
    n, s = o[0].shape[0], r2.shape[0]
    moving = bool(motion)
    with counts_kept():
        t, idx = smt.sphere_min_t(o, d, c, r2, active, t_min, t_max, **motion)
        g_t = torch.randn(n, generator=gen, device=t.device)
        bwd_args = (o, d, t, idx, g_t, c, r2, t_min, t_max)
        got = smt.sphere_min_t_bwd(*bwd_args, **motion)
        want = smt.sphere_min_t_bwd_plain(*bwd_args, **motion)
        torch.cuda.synchronize()
        pairs = list(zip((*got[0], *got[1]), (*want[0], *want[1])))
        err = max(float((a - b).abs().max()) for a, b in pairs)
        same = all(torch.equal(a, b) for a, b in pairs)
        n_hit = int((t < BIG).sum())
        out = {"max_abs_err": err, "bit_equal": same, "rays": n, "hits": n_hit,
               **bound(28 * n + (32 + 4 * moving) * n_hit + (16 + 12 * moving) * s,
                       (BWD_OPS + BWD_MOVE_OPS * moving) * n_hit),
               "ms": time_ms(lambda: smt.sphere_min_t_bwd(*bwd_args, **motion)),
               "device_ms": device_ms(lambda: smt.sphere_min_t_bwd(*bwd_args, **motion)),
               "cold_device_ms": device_ms(lambda: smt.sphere_min_t_bwd(*bwd_args, **motion),
                                           cold=True),
               "plain_ms": time_ms(lambda: smt.sphere_min_t_bwd_plain(*bwd_args, **motion))}
    phase("train", f"K1b sphere_min_t_bwd {label}: N={n} S={s} hits={n_hit} bit_equal={same} "
          f"max|d|={err!r}; call {out['ms']!r} ms, device {out['device_ms']!r} ms (L2 cold "
          f"{out['cold_device_ms']!r} ms), plain "
          f"{out['plain_ms']!r} ms (median of {TIMING_RUNS}); bound {out['bound_ms']!r} ms "
          f"by {out['bound_by']}")
    if not same:
        raise AssertionError(f"K1b {label}: the kernel disagrees with its plain version "
                             f"(max|d|={err})")
    return out


def grad_of_mean(scene, camera, cfg, weights=None):
    """-> (image (P, 3) numpy, gradient leaves numpy) of the mean of R + G + B
    of render_image_diff over all cells (each pixel weighted by `weights`)."""
    from raysnail_tpu_torch.diff import extract_params
    from raysnail_tpu_torch.diff.params import leaves
    from raysnail_tpu_torch.diff.train import render_image_diff

    p = extract_params(scene.arrays)
    img = render_image_diff(scene, camera, cfg, p, 0, np.arange(cfg.effective_samples))
    s = img.x + img.y + img.z
    if weights is not None:
        s = s * torch.as_tensor(weights, device=s.device)
    torch.mean(s).backward()
    return (img.to_array().detach().cpu().numpy(),
            [x.grad.cpu().numpy() if x.grad is not None else np.zeros(x.shape)
             for x in leaves(p)])


def grad_parity(make, cfg, device, label: str, counters) -> dict:
    """The card's gradient of the mean image against the CPU's, the same
    port on both sides and the same keys; -> the launches of the card's."""
    img_c, g_c = grad_of_mean(*make("cpu"), cfg)
    counters.reset()
    img_g, g_g = grad_of_mean(*make(device), cfg)
    torch.cuda.synchronize()
    launches = counters.read()
    flipped = np.abs(img_g - img_c).max(axis=1) > FLIP_ATOL
    if flipped.mean() > FLIP_SHARE:
        raise AssertionError(f"{label}: {int(flipped.sum())} pixels differ beyond {FLIP_ATOL}")
    if flipped.any():
        w = (~flipped).astype(np.float32)
        g_c = grad_of_mean(*make("cpu"), cfg, w)[1]
        g_g = grad_of_mean(*make(device), cfg, w)[1]
    worst = leaf_limit_check(f"{label}: the card's gradient against the CPU's", g_g, g_c)
    phase("train", f"{label} {cfg.width}x{cfg.height}@{cfg.effective_samples}spp depth "
          f"{cfg.max_depth}: card against CPU, every leaf within {GRAD_RTOL} * max|g| + "
          f"{GRAD_ATOL} (the largest at {worst!r} of its limit), {int(flipped.sum())} flipped "
          f"pixels left out; launches on the card {nonzero(launches)}")
    return launches


def metal_scene(device):
    """A scene whose bounce directions depend on the parameters (a
    DiffuseMetal's exponent and a BlinnPhong's lobe), so that the rays' t
    reaches the gradient through K1b: tests/test_diff.py's scene with its
    albedo sphere made DiffuseMetal and a BlinnPhong sphere beside it
    (tests/test_torch_diff.py's "metal" scene)."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5, ir.DiffuseMetal(30.0, ir.Constant((0.6, 0.3, 0.2)))))
    b.add(ir.Sphere((-1.0, 0.0, -1.5), 0.4, ir.BlinnPhong(0.4, 20.0, ir.Constant((0.2, 0.6, 0.3)))))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 4.0)),
          light=True)
    b.set_background((0.1, 0.1, 0.1))
    return b.compile(device=device)


def metal_camera(cfg, device):
    from raysnail_tpu_torch.camera import build_camera

    return build_camera(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=50, width=cfg.width,
                        height=cfg.height, device=device)


def train_steps(scene, camera, cfg, seeds, counters, label: str, card: str, may_trap=(),
                **kw) -> dict:
    """make_train_step's steps with the given seeds, timed together, after
    reset peak memory and launch counts -> seconds, loss, params, launches a
    step, peak bytes. The loss and every parameter must be finite, but the
    entries of `may_trap` ((leaf index, rows)): those that the JAX
    package's own square-root trap in `cosine_power_direction` can make NaN
    (ROADMAP section 3), which are counted and printed."""
    from raysnail_tpu_torch.diff import make_train_step
    from raysnail_tpu_torch.diff.params import leaves

    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    step, state, params = make_train_step(scene, camera, cfg, target, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the earlier phases' live tensors
    per_step = []
    t0 = time.perf_counter()
    for seed in seeds:  # the counts are the host's: reading them waits for nothing
        counters.reset()
        params, state, loss = step(params, state, seed, np.arange(cfg.effective_samples))
        per_step.append(counters.read())
    loss = float(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: sum(c[k] for c in per_step) / len(seeds) for k in per_step[0]}
    peak = torch.cuda.max_memory_allocated() - base
    rays = cfg.width * cfg.height * cfg.effective_samples * len(seeds)
    bad = {i: torch.nonzero(~torch.isfinite(x)).flatten().tolist()
           for i, x in enumerate(leaves(params)) if not bool(torch.isfinite(x).all())}
    trapped = {i: rows for i, rows in bad.items()
               if set(rows) <= set(dict(may_trap).get(i, ()))}
    out = {"seconds": seconds, "s_per_step": seconds / len(seeds),
           "mrays_fwd_bwd": rays / seconds / 1e6, "loss": loss, "launches": launches,
           "per_step": per_step, "peak_bytes": peak, "non_finite": bad,
           "params": [x.detach().clone() for x in leaves(params)]}
    phase("train", f"{label} {cfg.width}x{cfg.height}@{cfg.effective_samples}spp depth "
          f"{cfg.max_depth} on {card}: {len(seeds)} step(s) in {seconds!r} s, "
          f"{out['s_per_step']!r} s a step, {out['mrays_fwd_bwd']!r} Mrays/s fwd+bwd, loss "
          f"{loss!r}, peak {peak} B allocated above the {base} B live before; launches a "
          f"step {nonzero(launches)}; "
          f"non-finite parameters (leaf: rows) {bad}")
    if trapped != bad or not np.isfinite(loss):
        raise AssertionError(f"{label}: the step gave a non-finite loss or parameter")
    return out


def train_phase(device, card: str, counters, gen, k1b_cases, t_min, t_max) -> dict:
    """Phase 6: the gradient train step on the card -> K1b's record fields."""
    from raysnail_tpu_torch import integrator, ir
    from raysnail_tpu_torch import materials as matlib
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.diff import extract_params
    from raysnail_tpu_torch.diff.params import leaves
    from raysnail_tpu_torch.diff.train import render_image_diff
    from raysnail_tpu_torch.examples import inverse_rendering
    from raysnail_tpu_torch.scene import SceneBuilder
    from raysnail_tpu_torch.scenes.meshes import uv_sphere
    from raysnail_tpu_torch.sdl.driver import build_scene

    # (a) K1b against its plain version, bit for bit
    res = {label: check_bwd_kernel(args, motion, t_min, t_max, gen, label)
           for label, (args, motion) in k1b_cases.items()}

    # (b) the card's gradient against the CPU's
    gcfg = RenderConfig(width=GRAD_W, height=GRAD_H, samples=GRAD_SPP, max_depth=GRAD_DEPTH)
    grad_parity(lambda dev: build_scene(SCENE, gcfg, dev), gcfg, device, "example.sdl",
                counters)
    metal = grad_parity(lambda dev: (metal_scene(dev), metal_camera(gcfg, dev)), gcfg, device,
                        "metal", counters)
    if metal["sphere_min_t_bwd"] == 0:
        raise AssertionError("the metal scene's gradient did not launch K1b")
    v, f, nrm = uv_sphere(8, 12, center=(0.0, 0.0, -2.0))
    b = SceneBuilder()
    b.add(ir.Mesh(vertices=v, indices=f, normals=nrm,
                  material=ir.Lambertian(ir.Constant((0.7, 0.2, 0.2)))))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7, ir.DiffuseLight(ir.Constant((1, 1, 1)), 4.0)),
          light=True)
    mscene = b.compile(device=device)
    mcam = build_camera(look_from=(0, 0, 1), look_at=(0, 0, -2), fov=50, width=gcfg.width,
                        height=gcfg.height, device=device)
    counters.reset()
    params = extract_params(mscene.arrays)
    img = render_image_diff(mscene, mcam, gcfg, params, 0, np.arange(4))
    torch.mean(img.x + img.y + img.z).backward()
    torch.cuda.synchronize()
    mesh_launches = counters.read()
    grads = [x.grad for x in leaves(params) if x.grad is not None]
    if (mesh_launches["bvh_traverse/tri"] == 0 or img.x.grad_fn is None
            or not all(bool(torch.isfinite(g).all()) for g in grads)
            or float(params.tex_color1.x.grad.abs().max()) <= 1e-7):
        raise AssertionError("the mesh scene's gradient did not run K2, or is not finite")
    phase("train", f"mesh scene (tests/test_diff.py:126-150) {GRAD_W}x{GRAD_H}@4spp on the "
          f"card: every gradient finite, the mesh hit detached; launches "
          f"{nonzero(mesh_launches)}")

    # K1b on the main path: one Adam step of the metal scene at the
    # example-fwd+bwd size, through make_train_step
    tcfg = RenderConfig(width=TRAIN_W, height=TRAIN_H, samples=TRAIN_SPP, max_depth=TRAIN_DEPTH)
    mscene = metal_scene(device)
    mtype = mscene.arrays.materials.mtype.tolist()
    # the exponents that reach cosine_power_direction: DiffuseMetal's param0
    # (leaf 6) and BlinnPhong's param1 (leaf 7)
    lobes = ((6, [i for i, m in enumerate(mtype) if m == matlib.DIFFUSE_METAL]),
             (7, [i for i, m in enumerate(mtype) if m == matlib.BLINN_PHONG]))
    mstep = train_steps(mscene, metal_camera(tcfg, device), tcfg, [0], counters,
                        "metal train step (K1b's main path)", card, may_trap=lobes)
    if mstep["launches"]["sphere_min_t_bwd"] == 0:
        raise AssertionError("the metal train step did not launch K1b")
    # run twice on the same inputs: the same bits in every leaf (NaN traps
    # compared as bit patterns)
    again = train_steps(mscene, metal_camera(tcfg, device), tcfg, [0], counters,
                        "metal train step, again", card, may_trap=lobes)
    differ = bits_differ(mstep["params"], again["params"])
    phase("train", f"metal train step run twice on the same inputs: leaves whose bits differ "
          f"{differ} of {len(mstep['params'])}")
    if differ:
        raise AssertionError(f"the metal train step does not repeat its bits: leaves {differ}")

    # (c) bench.py's example-fwd+bwd row: a warm-up step, then TRAIN_STEPS
    scene, camera = build_scene(SCENE, tcfg, device)
    warm = train_steps(scene, camera, tcfg, [0], counters, "example-fwd+bwd warm-up", card)
    row = train_steps(scene, camera, tcfg, list(range(1, TRAIN_STEPS + 1)), counters,
                      "example-fwd+bwd", card)
    # K1's launches in the first timed step (seed 1) by pass: pass 1 alone,
    # then the same step without remat
    counters.reset()
    with torch.no_grad():
        _, pass1_iterations = integrator.radiance_regen_shuffle(
            scene, scene.arrays, tcfg, camera, 1, tcfg.effective_samples)
    torch.cuda.synchronize()
    pass1 = counters.read()["sphere_min_t"]
    no_remat = train_steps(scene, camera, tcfg.replace(remat_bounces=False), [1], counters,
                           "example-fwd+bwd without remat", card)
    k1 = row["per_step"][0]["sphere_min_t"]
    k1_fwd = no_remat["launches"]["sphere_min_t"] - pass1
    phase("train", f"example-fwd+bwd K1 launches in its step of seed 1: {k1:g} = pass 1 {pass1} "
          f"({pass1_iterations} shade iterations) + the cells' forward {k1_fwd:g} + their "
          f"recompute in the backward pass {k1 - pass1 - k1_fwd:g}; K1b "
          f"{row['launches']['sphere_min_t_bwd']:g} (all Lambertian: no ray depends on a "
          f"parameter); peak {row['peak_bytes']} B with remat, {no_remat['peak_bytes']} B without")

    # (d) the canonical step: 800x500@64, depth 8, one backward pass a cell
    ccfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SAMPLES, max_depth=TRAIN_DEPTH)
    cscene, ccam = build_scene(SCENE, ccfg, device)
    canon = train_steps(cscene, ccam, ccfg, [1], counters, "example-fwd+bwd-800x500", card)
    # one of its cells, forward (with the recompute) and backward, under the
    # profiler: where the step's time goes
    def cell_loss(sc, cam):
        p = extract_params(sc.arrays)
        img = render_image_diff(sc, cam, ccfg, p, 1, [0])
        return torch.mean(img.x + img.y + img.z)

    cell = lambda: cell_loss(cscene, ccam).backward()  # noqa: E731
    cell()
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    cell()
    torch.cuda.synchronize()
    cell_wall, cell_launches = time.perf_counter() - t0, counters.read()
    phase("train", f"one cell of example-fwd+bwd-800x500: {cell_wall!r} s, launches "
          f"{nonzero(cell_launches)}")
    profile_frame(cscene, ccam, ccfg, "one cell of example-fwd+bwd-800x500 (forward, "
                  "recompute, backward)", cell_wall, run=cell,
                  kernel=("sphere_min_t", "rows_select"), kernel_name="K1, K1b, K7 and K7b")
    kernels = {"K7b": "rows_select_bwd", "K1b": "sphere_min_t_bwd"}
    canon_bwd = profile_backward(lambda: cell_loss(cscene, ccam),
                                 "one cell of example-fwd+bwd-800x500", kernels)
    # the metal scene's cell at the same size: K1b in its own place
    mcscene, mccam = metal_scene(device), metal_camera(ccfg, device)
    cell_loss(mcscene, mccam).backward()
    with k1b_inputs() as calls:
        cell_loss(mcscene, mccam).backward()
        torch.cuda.synchronize()
    k1b_bound = sum(bound(28 * n + (32 + 4 * mv) * int(hit) + (16 + 12 * mv) * s,
                          (BWD_OPS + BWD_MOVE_OPS * mv) * int(hit))["bound_ms"]
                    for n, hit, s, mv in calls)
    metal_bwd = profile_backward(lambda: cell_loss(mcscene, mccam),
                                 "one cell of the metal scene at 800x500", kernels)
    k1b = metal_bwd["K1b"]
    k1b.update(bound_ms=k1b_bound, bound_ms_a_launch=k1b_bound / max(len(calls), 1),
               calls=len(calls), half_of_bound=k1b["device_ms"] <= 2 * k1b_bound)
    phase("train", f"K1b in place (the metal cell's backward pass): {k1b['launches']} launches, "
          f"{k1b['device_ms']!r} ms of device time, {k1b['ms_a_launch']!r} ms a launch, "
          f"against its bound {k1b_bound!r} ms for the {len(calls)} calls' rays "
          f"({[(n, int(h)) for n, h, _, _ in calls]} rays, rays that hit); within twice its "
          f"bound {k1b['half_of_bound']}")
    for label, bwd_res in (("canonical", canon_bwd), ("metal", metal_bwd)):
        if bwd_res["index_add"] or bwd_res["K7b"]["launches"] == 0:
            raise AssertionError(f"the {label} cell's backward pass still runs index_add "
                                 f"{bwd_res['index_add']}, or did not launch K7b")
    # (e) the inverse-rendering example at its own size
    counters.reset()
    t0 = time.perf_counter()
    losses, alb = inverse_rendering.run(device, EXAMPLE_STEPS, out=lambda m: phase("train", m))
    torch.cuda.synchronize()
    phase("train", f"inverse_rendering.run, {EXAMPLE_STEPS} Adam(2e-2) steps at 64x48@16spp "
          f"depth 4 on {card}: {time.perf_counter() - t0!r} s, loss {losses[0]!r} -> "
          f"{losses[-1]!r}, albedo {alb.tolist()}; launches {nonzero(counters.read())}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the inverse-rendering example's loss did not fall")
    return {"cases": res, "metal": mstep, "warm": warm, "row": row, "no_remat": no_remat,
            "canonical": canon, "pass1": pass1, "cell_launches": cell_launches,
            "canonical_bwd": canon_bwd, "metal_bwd": metal_bwd}


def bits_differ(a: list, b: list) -> list:
    """The indices of the leaves (tensors or arrays) whose bit patterns
    differ, NaNs included."""
    as_bits = lambda x: (x.view(torch.int32) if isinstance(x, torch.Tensor)  # noqa: E731
                         else torch.from_numpy(np.ascontiguousarray(x).view(np.int32)))
    return [i for i, (x, y) in enumerate(zip(a, b))
            if not torch.equal(as_bits(x).cpu(), as_bits(y).cpu())]


@contextlib.contextmanager
def k1b_inputs():
    """Records (rays, rays that hit as a tensor, spheres, moving) of each K1b
    call inside the block: its bound in place. The recorder stands in for
    `sphere_min_t_bwd` in its module (SphereMinT's backward calls it by
    that name) and hands its launch counts back on the way out."""
    from raysnail_tpu_torch.ops import sphere_min_t as smt

    calls, orig = [], smt.sphere_min_t_bwd

    def recorder(o, d, t, idx, g_t, c, r2, *args, **kw):
        calls.append((t.shape[0], (t < BIG).sum(), r2.shape[0], "time" in kw))
        return orig(o, d, t, idx, g_t, c, r2, *args, **kw)

    recorder.launches, recorder.moving_launches = orig.launches, orig.moving_launches
    smt.sphere_min_t_bwd = recorder
    try:
        yield calls
    finally:
        smt.sphere_min_t_bwd = orig
        orig.launches, orig.moving_launches = recorder.launches, recorder.moving_launches


# index_add_'s op and its kernels (indexFunc*), and index_put_'s accumulating
# kernel: none may run in a cell's backward pass
INDEX_ADD_KEYS = ("index_add", "indexFunc", "indexing_backward")


def profile_backward(forward, label: str, kernels: dict) -> dict:
    """torch.profiler over the backward pass alone of the scalar that
    `forward()` returns (the forward runs first, outside it): its device
    time, wall, busy share and cudaLaunchKernel calls; the device time,
    launches and ms a launch of each kernel of `kernels` ({name: key
    substring}); and the index_add ops and kernels it ran (INDEX_ADD_KEYS)."""
    from torch.profiler import ProfilerActivity, profile

    loss = forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    averages = prof.key_averages()
    events = _device_events(prof)
    total = sum(_dev_us(e) for e in events)
    out = {"device_ms": total / 1e3, "wall_s": wall,
           "launches": sum(e.count for e in averages if e.key == "cudaLaunchKernel"),
           "index_add": {e.key: e.count for e in averages
                         if any(t in e.key for t in INDEX_ADD_KEYS)}}
    for name, key in kernels.items():
        mine = [e for e in events if key in _kernel_key(e)]
        us, n = sum(_dev_us(e) for e in mine), sum(e.count for e in mine)
        out[name] = {"device_ms": us / 1e3, "launches": n, "ms_a_launch": us / 1e3 / max(n, 1)}
    phase("train", f"{label}, its backward pass alone under the profiler: {wall!r} s wall, "
          f"device {total / 1e3!r} ms (busy {100 * total / 1e6 / wall:.2f}%), "
          f"{out['launches']} cudaLaunchKernel; "
          + ", ".join(f"{k} {out[k]['launches']} launches {out[k]['device_ms']!r} ms"
                      for k in kernels)
          + f"; index_add ops and kernels {out['index_add']}")
    for e in sorted(events, key=_dev_us, reverse=True)[:8]:
        phase("train", f"  {_dev_us(e) / 1e3:10.3f} ms  {100 * _dev_us(e) / total:6.2f}%  "
              f"x{e.count:<7d} {e.key[:90]}")
    return out


def leaf_limit_check(label: str, got: list, want: list) -> float:
    """Each leaf of `got` within GRAD_RTOL * max|want| + GRAD_ATOL of
    `want`'s (PERF.md section 2's gradient limit) -> the largest share of
    its limit a leaf used."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        limit = GRAD_RTOL * float(np.abs(b).max(initial=0.0)) + GRAD_ATOL
        d = float(np.abs(a - b).max(initial=0.0))
        worst = max(worst, d / limit)
        if not (np.isfinite(a).all() and np.isfinite(b).all()) or d > limit:
            raise AssertionError(f"{label}: leaf {i} differs by {d} > {limit}, or is not finite")
    return worst


def sharded_phase(device, card: str, counters) -> dict:
    """Phase 7: the sharded paths in a one-rank NCCL group on `device` ->
    the launch counts of the frame step's and the mesh check's runs."""
    import torch.distributed as dist

    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.diff import make_train_step
    from raysnail_tpu_torch.diff.params import leaves
    from raysnail_tpu_torch.painter import RenderSession, RenderState
    from raysnail_tpu_torch.parallel import (distributed, dryrun, make_mesh,
                                             make_padded_sharded_step, make_sharded_frame_step,
                                             make_sharded_train_step, render_sharded)
    from raysnail_tpu_torch.render import (_tile_grid, _to_image, make_frame_step,
                                           render_passes, render_sums)
    from raysnail_tpu_torch.sdl.driver import build_scene

    world = distributed.initialize(device=device)
    try:
        mesh = make_mesh()
        if world != 1 or dist.get_backend() != "nccl" or mesh.device != device:
            raise AssertionError(f"a one-rank NCCL group on {device} was asked for; got "
                                 f"{world} rank(s), {dist.get_backend()}, {mesh.device}")
        phase("sharded", f"one-rank {dist.get_backend()} group on {mesh.device}, mesh "
              f"{mesh.shape}, NCCL {torch.cuda.nccl.version()}")
        t_phase = time.perf_counter()
        out = {}

        # (a) the sharded frame step against make_frame_step, bit for bit
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SAMPLES)
        spp = cfg.effective_samples
        scene, camera = build_scene(SCENE, cfg, device)
        single = make_frame_step(scene, cfg)
        sharded = make_sharded_frame_step(scene, cfg, mesh)

        def timed(step, seed=0):
            counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums, iterations = step(scene.arrays, camera, seed)
            torch.cuda.synchronize()
            return sums, iterations, time.perf_counter() - t0, counters.read()

        a1, it_single, s1, _ = timed(single)
        b1, it_sharded, t1, out["frame"] = timed(sharded)
        b2, _, t2, _ = timed(sharded)
        a2, _, s2, _ = timed(single)
        same = all(torch.equal(x, y) for x, y in zip(a1, b1))
        rays = WIDTH * HEIGHT * spp
        flat = b1.to_array()
        reduce_ms = time_ms(lambda: dist.all_reduce(flat))
        reduce_bound = bound(2 * flat.numel() * 4, 0)  # one rank: nothing to add
        phase("sharded", f"(a) sharded frame step, example.sdl {WIDTH}x{HEIGHT}@{spp}spp depth "
              f"{cfg.max_depth} on {card}: bit-equal to make_frame_step {same}; walls "
              f"(single, sharded, sharded, single) {[s1, t1, t2, s2]!r} s; sharded "
              f"{rays / min(t1, t2) / 1e6!r} Mprimary-rays/s at its best, single "
              f"{rays / min(s1, s2) / 1e6!r}; shade iterations {it_sharded} (single "
              f"{it_single}); launches {nonzero(out['frame'])}; all_reduce of "
              f"{flat.numel()} f32 ({flat.numel() * 4} B) alone: {reduce_ms!r} ms (median of "
              f"{TIMING_RUNS}, CUDA events), bound {reduce_bound['bound_ms']!r} ms by "
              f"{reduce_bound['bound_by']}")
        if not same or out["frame"]["sphere_min_t"] < it_sharded:
            raise AssertionError("the sharded frame step is not the single-device one's bits, "
                                 "or did not go through K1")

        # (b) render_sharded against render_sums in tile order
        px, py, inv = _tile_grid(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counters.reset()
        t0 = time.perf_counter()
        img = render_sharded(scene, camera, cfg, mesh, seed=0)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = counters.read()
        t0 = time.perf_counter()
        ref = _to_image(render_sums(scene, camera, cfg, 0, px, py), cfg)[inv]
        ref_seconds = time.perf_counter() - t0
        d = float(np.abs(img - ref.reshape(img.shape)).max())
        phase("sharded", f"(b) render_sharded {WIDTH}x{HEIGHT}@{spp}spp on {card}: "
              f"{seconds!r} s (render_sums in tile order {ref_seconds!r} s), max |d| against "
              f"render_sums {d!r} (<= {SHARD_ATOL}), peak {peak} B allocated above the {base} "
              f"B live before; launches {nonzero(launches)}; image mean {img.mean()!r}")
        if d > SHARD_ATOL or not np.isfinite(img).all() or launches["sphere_min_t"] == 0:
            raise AssertionError("render_sharded is off render_sums or did not go through K1")

        # (c) adaptive passes: the sharded frame step, then the padded step
        pcfg = cfg.replace(samples=PASSES_SAMPLES, passes=2)
        pstep = make_padded_sharded_step(scene, pcfg, mesh)
        counters.reset()
        t0 = time.perf_counter()
        img = render_passes(scene, camera, pcfg, seed=0, step=pstep,
                            k_multiple=mesh.shape["sample"],
                            frame_step=make_sharded_frame_step(scene, pcfg, mesh))
        seconds = time.perf_counter() - t0
        launches = counters.read()
        ref = render_passes(scene, camera, pcfg, seed=0)
        d = float(np.abs(img - ref).max())
        phase("sharded", f"(c) render_passes passes=2 {WIDTH}x{HEIGHT}@"
              f"{pcfg.effective_samples}spp through the sharded frame step and the padded "
              f"step on {card}: {seconds!r} s, max |d| against the single-device passes {d!r} "
              f"(<= {SHARD_ATOL}, bit-equal {d == 0.0}); launches {nonzero(launches)}")
        if d > SHARD_ATOL or not np.isfinite(img).all():
            raise AssertionError("the sharded passes are off the single-device passes")

        # (d) a checkpointed RenderSession through the padded step, resumed
        km = mesh.shape["sample"]
        scfg = pcfg.replace(ray_batch=4 * WIDTH * HEIGHT)  # chunks of 4 cells
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            RenderSession(scene, camera, scfg, seed=3, checkpoint_path=path, step=pstep,
                          k_multiple=km).render(target=lambda done, total, im: False)
            dist.barrier()
            state = RenderState.load(path)
        t0 = time.perf_counter()
        resumed = RenderSession(scene, camera, scfg, seed=3, step=pstep,
                                k_multiple=km).render(resume=state)
        seconds = time.perf_counter() - t0
        full = RenderSession(scene, camera, scfg, seed=3, step=pstep, k_multiple=km).render()
        d = float(np.abs(resumed - full).max())
        phase("sharded", f"(d) RenderSession {WIDTH}x{HEIGHT}@{pcfg.effective_samples}spp "
              f"through the padded step: checkpoint at {state.samples_done} of "
              f"{pcfg.effective_samples} cells, resumed in {seconds!r} s, max |d| against an "
              f"uninterrupted session {d!r} (exact: 0)")
        if not 0 < state.samples_done < scfg.effective_samples or d != 0.0:
            raise AssertionError("the sharded checkpoint resume is not exact")

        # (e) one SGD step of lr 1 (p0 - p1 is the gradient), sharded and
        # single-device, each twice on the same inputs
        tcfg = RenderConfig(width=TRAIN_W, height=TRAIN_H, samples=TRAIN_SPP,
                            max_depth=TRAIN_DEPTH)
        tscene, tcam = build_scene(SCENE, tcfg, device)
        target = np.zeros((TRAIN_H, TRAIN_W, 3), np.float32)
        sgd = lambda xs: torch.optim.SGD(xs, lr=1.0)  # noqa: E731
        grads, losses, walls = {}, {}, {}
        step1, st1, p0 = make_train_step(tscene, tcam, tcfg, target, optimizer=sgd)
        stepn, stn, _ = make_sharded_train_step(tscene, tcam, tcfg, target, mesh, optimizer=sgd)
        base = [x.detach() for x in leaves(p0)]
        runs = (("single", lambda: step1(p0, st1, 1, np.arange(tcfg.effective_samples))),
                ("sharded", lambda: stepn(p0, stn, 1)))
        for label, run_step in runs + runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p1, _, loss = run_step()
            torch.cuda.synchronize()
            walls.setdefault(label, []).append(time.perf_counter() - t0)
            losses.setdefault(label, []).append(float(loss))
            grads.setdefault(label, []).append([(x0 - x).cpu().numpy()
                                                for x0, x in zip(base, leaves(p1))])
        worst = leaf_limit_check("sharded train step against make_train_step",
                                 grads["sharded"][0], grads["single"][0])
        spread = {}
        for label, (g_a, g_b) in grads.items():
            n_diff = len(bits_differ(g_a, g_b))
            dmax = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(g_a, g_b))
            spread[label] = (n_diff, dmax, leaf_limit_check(f"{label} step run twice", g_b, g_a))
        trays = TRAIN_W * TRAIN_H * tcfg.effective_samples
        phase("sharded", f"(e) make_sharded_train_step {TRAIN_W}x{TRAIN_H}@"
              f"{tcfg.effective_samples}spp depth {TRAIN_DEPTH}, one SGD(1.0) step, on {card}: "
              f"walls (s) {walls}, sharded {trays / min(walls['sharded']) / 1e6!r} Mrays/s "
              f"fwd+bwd at its best; losses {losses}; every leaf of the sharded gradient "
              f"within {GRAD_RTOL} * max|g| + {GRAD_ATOL} of make_train_step's (the largest "
              f"at {worst!r} of its limit); run twice: (leaves whose bits differ of 10, "
              f"largest difference, share of the limit) {spread}")
        if not np.isclose(losses["sharded"][0], losses["single"][0], rtol=1e-4):
            raise AssertionError(f"the sharded loss is off the single-device one: {losses}")
        if any(n_diff for n_diff, _, _ in spread.values()):
            raise AssertionError(f"a train step run twice on the same inputs gave other bits "
                                 f"(leaves that differ, largest difference, share): {spread}")

        # (f) the dry run's forced mesh check: K2
        counters.reset()
        sums = dryrun.check_mesh_kernel(mesh)
        torch.cuda.synchronize()
        out["mesh"] = counters.read()
        phase("sharded", f"(f) dryrun.check_mesh_kernel (uv-sphere, mesh_pallas='force') "
              f"on {card}: sums finite, mean {float(sums.mean())!r}; launches "
              f"{nonzero(out['mesh'])}")
        out["k2"] = sum(v for k, v in out["mesh"].items()
                        if k.startswith("bvh_traverse/") and "/tri" in k)
        if out["k2"] == 0:
            raise AssertionError("the sharded mesh check did not launch K2")
        phase("sharded", f"phase in {time.perf_counter() - t_phase:.1f} s")
        return out
    finally:
        dist.destroy_process_group()


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _device_events(prof) -> list:
    """The profiler's device-side (kernel and memcpy) entries: a CPU op's
    device time repeats its kernels' and is not summed again."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def profile_kernels(cases: dict, t_min, t_max, label: str):
    """Device ms per call (device_ms) of each traversal kind through the
    per-ray kernel (tri, box, sphere) and the packet kernel (all four, modes
    off), on the inputs of phase 3 (`label` names the rays)."""
    from raysnail_tpu_torch.ops import bvh_traverse as bt

    for kind in cases:
        for packet in (False, True):
            if not packet and kind not in bt._PER_RAY_KINDS:
                continue
            ms = device_ms(lambda: bt.bvh_traverse(*cases[kind], t_min, t_max, kind=kind,
                                                   packet=packet, stream=False,
                                                   two_level=False))
            phase("profile", f"{'packet' if packet else 'per-ray'} {kind}, {label}, "
                  f"N={cases[kind][0][0].shape[0]}: {ms!r} ms device time per call "
                  f"({TIMING_RUNS} back to back)")


def _kernel_key(e) -> str:
    return e.key.replace("(bool)1", "true").replace("(bool)0", "false")


@contextlib.contextmanager
def counts_kept():
    """Every kernel's launch count is left as it was by the block: the
    launches made to measure a kernel are not the main path's."""
    from raysnail_tpu_torch.ops import bvh_traverse as bt
    from raysnail_tpu_torch.ops import mandelbulb_march as mm
    from raysnail_tpu_torch.ops import rows_select as rs
    from raysnail_tpu_torch.ops import sphere_min_t as smt

    saved = (smt.sphere_min_t.launches, smt.sphere_min_t.moving_launches,
             smt.sphere_min_t_bwd.launches, smt.sphere_min_t_bwd.moving_launches,
             mm.mandelbulb_march.launches, dict(bt.bvh_traverse.launches),
             rs.rows_select.launches, rs.rows_select_bwd.launches)
    try:
        yield
    finally:
        (smt.sphere_min_t.launches, smt.sphere_min_t.moving_launches,
         smt.sphere_min_t_bwd.launches, smt.sphere_min_t_bwd.moving_launches,
         mm.mandelbulb_march.launches, bt.bvh_traverse.launches,
         rs.rows_select.launches, rs.rows_select_bwd.launches) = saved


SPIN_CYCLES = int(2e8)  # about 0.1 s at the H100's 1.98 GHz: longer than queuing the calls
L2_FLUSH_BYTES = 128 << 20  # written between calls by device_ms(cold=True): 2.5x the L2


def device_ms(fn, runs: int = TIMING_RUNS, cold: bool = False) -> float:
    """Device milliseconds per call of `fn`: after a warm-up, `runs` calls
    queued behind a spin kernel (torch.cuda._sleep), so that the card runs
    them back to back, timed between two CUDA events. Raises if queuing the
    calls outlasted the spin, when host time would have entered.
    cold=True writes L2_FLUSH_BYTES before each call, outside its events
    (a pair of events a call, their times summed), so that the call finds
    its inputs in device memory and not in the 50 MB L2 cache."""
    with counts_kept():
        fn()
        torch.cuda.synchronize()
        flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(runs if cold else 1)]
        start, end = pairs[0][0], pairs[-1][1]
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        if cold:
            for i, (a, b) in enumerate(pairs):
                flush.fill_(float(i))
                a.record()
                fn()
                b.record()
        else:
            start.record()
            for _ in range(runs):
                fn()
            end.record()
        queued = time.perf_counter() - t0
        end.synchronize()
        spin = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event(enable_timing=True)
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES)
        spun.record()
        spun.synchronize()
    if queued * 1e3 >= spin.elapsed_time(spun):
        raise AssertionError(f"device_ms: queuing {runs} calls took {queued:.4f} s, longer "
                             f"than the spin kernel")
    if cold:
        return sum(a.elapsed_time(b) for a, b in pairs) / runs
    return start.elapsed_time(end) / runs


def sphere_crossover(gen, device):
    """Static sphere groups of CROSSOVER_S random spheres (centers in
    [-20, 20]^3, radii 0.2-0.6) against one set of WIDTH x HEIGHT random
    uncapped rays: device ms per call (device_ms) of the dense sweep (K1) and
    of the BVH traversal's kind "sphere" (K4) per ray and per packet."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.ops import bvh_traverse as bt
    from raysnail_tpu_torch.ops import sphere_min_t as smt
    from raysnail_tpu_torch.scene import SceneBuilder

    n = WIDTH * HEIGHT
    o, d, _ = random_rays(gen, n, (-25.0,) * 3, (25.0,) * 3, device)
    cap = torch.full((n,), BIG, device=device)
    rng = np.random.default_rng(13)
    for s in CROSSOVER_S:
        b = SceneBuilder()
        for c in rng.uniform(-20, 20, (s, 3)):
            b.add(ir.Sphere(tuple(c), float(rng.uniform(0.2, 0.6)),
                            ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
        g = b.compile(device=device).arrays.spheres
        dense = (cols(o), cols(d), tuple(g.center), (g.radius * g.radius).contiguous(), g.active)
        bvh = (cols(o), cols(d), cap, g.pk_bb, g.pk_links, g.pk_sph)
        k1 = lambda: smt.sphere_min_t(*dense, 1e-3, BIG)
        k4 = lambda packet: bt.bvh_traverse(*bvh, 1e-3, BIG, kind="sphere", packet=packet,
                                            stream=False, two_level=False)
        with counts_kept():
            t1, t4 = k1()[0], k4(False)[0]
        ms = {"K1": device_ms(k1), "K4 per ray": device_ms(lambda: k4(False)),
              "K4 packet": device_ms(lambda: k4(True))}
        phase("profile", f"crossover, S={s} static spheres x {n} rays: device ms per call "
              f"{ms}; hits K1 {int((t1 < BIG).sum())}, K4 {int((t4 < BIG).sum())}, "
              f"t differs on {int((t1 != t4).sum())} rays")


def profile_frame(scene, camera, cfg, label: str, wall_s: float, seed: int = MESH_SEED,
                  kernel=("bvh_traverse_kernel", "bvh_packet_kernel"),
                  kernel_name: str = "traversal kernel", run=None):
    """torch.profiler over one frame (the frame step, or `run()` where
    given): device time by kernel, the share and time per launch of the
    kernels whose names hold one of `kernel`, and the busy share against the
    unprofiled frame's wall time `wall_s`. Its shade iterations are counted
    as its scene.intersect calls."""
    from torch.profiler import ProfilerActivity, profile

    from raysnail_tpu_torch.render import make_frame_step

    if run is None:
        step = make_frame_step(scene, cfg)
        run = lambda: step(scene.arrays, camera, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with intersect_calls() as calls, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    iterations = calls["n"]

    events = _device_events(prof)
    total = sum(_dev_us(e) for e in events)
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    phase("profile", f"{label}, under the profiler: {iterations} iterations, "
          f"{prof_wall:.3f} s wall, device time {total / 1e3:.3f} ms, "
          f"{launches} cudaLaunchKernel calls")
    for e in sorted(events, key=_dev_us, reverse=True)[:8]:
        phase("profile", f"  {_dev_us(e) / 1e3:10.3f} ms  {100 * _dev_us(e) / total:6.2f}%  "
              f"x{e.count:<7d} {e.key[:90]}")
    mine = [e for e in events if any(t in _kernel_key(e) for t in kernel)]
    k_us, k_n = sum(_dev_us(e) for e in mine), sum(e.count for e in mine)
    phase("profile", f"{label}: {kernel_name} {k_us / 1e3:.3f} ms "
          f"({100 * k_us / total:.2f}% of device time) in {k_n} launches, "
          f"{k_us / 1e3 / max(k_n, 1)!r} ms per launch; device busy "
          f"{100 * total / 1e6 / wall_s:.2f}% of the unprofiled frame's {wall_s:.3f} s wall")


if __name__ == "__main__":
    sys.exit(main())
