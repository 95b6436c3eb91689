"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with a CUDA card, nvcc and g++.
It drives `raysnail_tpu_torch` (never the JAX package) through these phases
and exits non-zero if any fails:

  1. device   require CUDA; print the card's name and power limit
  2. build    build every kernel of the render paths from csrc/ with nvcc,
              and the host BVH builder with g++, all started together; the
              seconds, and each kernel's registers and spills (-Xptxas -v)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the render paths' shapes and at stress shapes; CUDA-event times
  4. golden   the anchors example.sdl, mesh, mesh-binned, boxfield-kernel
              and book1-spherebvh on the card, against the committed
              tests/golden/golden.npz, with the kernel launches of each
  5. main     the canonical frame, example.sdl at 800x500@64spp (a warm-up
              through the CLI, then a timed run of the same calls); then the
              mesh-200k frame, a 204,800-triangle knot at 320x200@16spp,
              depth 6 (a warm-up, then timed with "entry" binning and with
              none); then the 9,600-triangle mesh+arealight frame. Each run
              reads the kernel launch counts it made.
  6. profile  (only with --profile) torch.profiler: the device time of one
              call of each traversal kind and of its plain version; over one
              mesh-200k frame, device time by kernel, the traversal
              kernel's share and the device's busy share

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without CUDA it exits non-zero before
printing any result.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
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
TIMING_RUNS = 20
PLAIN_RUNS = 3                               # the plain BVH walk takes up to seconds
ANCHORS = ("example.sdl", "mesh", "mesh-binned", "boxfield-kernel", "book1-spherebvh")
BIG = 1e30


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


def check_sphere_kernel(args, t_min, t_max, label: str, time_it: bool):
    """Kernel vs plain on the same inputs: idx equal, t bit-equal (the kernel
    is built with -fmad=false, so both round every operation alike)."""
    from raysnail_tpu_torch.ops.sphere_min_t import sphere_min_t, sphere_min_t_plain

    before = sphere_min_t.launches
    t_k, i_k = sphere_min_t(*args, t_min, t_max)
    t_p, i_p = sphere_min_t_plain(*args, t_min, t_max)
    torch.cuda.synchronize()
    err = float((t_k - t_p).abs().max())
    same_idx = bool(torch.equal(i_k, i_p))
    n_hit = int((t_p < BIG).sum())
    out = {"max_abs_err": err, "idx_equal": same_idx, "hits": n_hit}
    if time_it:
        out["ms"] = time_ms(lambda: sphere_min_t(*args, t_min, t_max))
        out["plain_ms"] = time_ms(lambda: sphere_min_t_plain(*args, t_min, t_max))
    sphere_min_t.launches = before  # comparison launches are not the main path's
    n, s = args[0][0].shape[0], args[3].shape[0]
    phase("kernels", f"sphere_min_t {label}: N={n} S={s} hits={n_hit} "
          f"max|dt|={err!r} idx_equal={same_idx}"
          + (f" kernel {out['ms']!r} ms, plain {out['plain_ms']!r} ms (median of "
             f"{TIMING_RUNS})" if time_it else ""))
    if not same_idx or err != 0.0:
        raise AssertionError(f"sphere_min_t {label}: kernel disagrees with the plain "
                             f"version (max|dt|={err}, idx_equal={same_idx})")
    return out, (t_k, i_k)


def check_bvh_kernel(kind, args, t_min, t_max, label: str, time_it: bool):
    """bvh_traverse kernel vs its plain version on the same inputs: t and
    every attribute bit-equal, i.e. the same winner on every ray."""
    from raysnail_tpu_torch.ops import bvh_traverse as bt

    before = dict(bt.bvh_traverse.launches)
    t0 = time.perf_counter()
    out = bt.bvh_traverse(*args, t_min, t_max, kind=kind)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = bt.bvh_traverse_plain(*args, t_min, t_max, kind=kind)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err = float((out[0] - ref[0]).abs().max())
    same = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
    t, cap = out[0], args[2]
    n_hit = int((t < BIG).sum())
    dead_ok = bool((t[cap <= 0] == BIG).all()) and all(
        bool((a[cap <= 0] == 0).all()) for a in out[1:])
    res = {"max_abs_err": err, "equal": all(same), "hits": n_hit}
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
          f"{t1 - t0:.3f} s, plain {t2 - t1:.3f} s"
          + (f"; kernel {res['ms']!r} ms (median of {TIMING_RUNS}), plain "
             f"{res['plain_ms']!r} ms (median of {PLAIN_RUNS})" if time_it else ""))
    if not all(same) or err != 0.0 or not dead_ok or n_hit == 0:
        raise AssertionError(f"bvh_traverse {kind} {label}: kernel disagrees with the "
                             f"plain version (max|dt|={err}, equal={same}, dead ok "
                             f"{dead_ok}, hits {n_hit})")
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


class Counters:
    """Every kernel's launch count: reset to 0 before a run, read after."""

    def __init__(self):
        from raysnail_tpu_torch.ops import bvh_traverse as bt
        from raysnail_tpu_torch.ops import sphere_min_t as smt
        self.smt, self.bt = smt.sphere_min_t, bt.bvh_traverse

    def reset(self):
        self.smt.launches = 0
        self.bt.launches = {k: 0 for k in self.bt.launches}

    def read(self) -> dict:
        return {"sphere_min_t": self.smt.launches,
                **{f"bvh_traverse/{k}": v for k, v in self.bt.launches.items()}}


def main() -> int:
    # 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "smoke run needs a CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    kernels = run(torch.device("cuda", 0), card, profile="--profile" in sys.argv[1:])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def run(device: torch.device, card: str, profile: bool) -> list:
    """Phases 2-6 on `device`; -> the kernels' JSON records."""
    from raysnail_tpu_torch import cli, integrator
    from raysnail_tpu_torch.accel.native import build as native
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.ops import _nvcc
    from raysnail_tpu_torch.ops import bvh_traverse as bt
    from raysnail_tpu_torch.ops import sphere_min_t as smt
    from raysnail_tpu_torch.geometry import spheres as sphlib
    from raysnail_tpu_torch.render import render
    from raysnail_tpu_torch.scene import SceneBuilder
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.sdl.driver import build_scene
    from raysnail_tpu_torch.utils import golden

    # 2. build: one compiler process per source, all started together -----
    t0 = time.time()
    jobs = {"sphere_min_t.cu": lambda: smt.build(verbose=True),
            "bvh_traverse.cu": lambda: bt.build(verbose=True),
            "bvh_builder.cpp": native.build}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        libs = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        phase("build", f"{name} -> {os.path.relpath(lib, ROOT)}")
    phase("build", f"all built in {time.time() - t0:.2f} s (nvcc {' '.join(_nvcc.NVCC_FLAGS)}; "
          f"g++ {' '.join(native.GXX_FLAGS)})")

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
    args_c = sphere_case(gen, 65_537, 256, device, duplicate=True)
    res_c, (t_c, i_c) = check_sphere_kernel(args_c, cfg.t_min, BIG, "(c) duplicated spheres",
                                            time_it=False)
    hit_c = t_c < BIG
    if int(hit_c.sum()) == 0 or bool((i_c[hit_c] % 2 == 1).any()):
        raise AssertionError("sphere_min_t (c): a tie did not go to the first index")
    phase("kernels", f"sphere_min_t (c): every tie went to the first copy "
          f"({int(hit_c.sum())} hits)")
    smt_err = max(r["max_abs_err"] for r in (res_a, res_b, res_c))

    # bvh_traverse, kind "tri": the mesh-200k scene (its host compile is timed)
    mcfg = RenderConfig(width=MESH_W, height=MESH_H, samples=MESH_SPP, max_depth=MESH_DEPTH)
    t0 = time.perf_counter()
    mscene, mcam = golden.mesh_scene(mcfg, device, n_seg=1600, n_ring=64)
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
    # (b) divergent rays from inside and around the knot's bounds
    root = tri.pk_bb[0, 0, :6]
    o, d, cap = random_rays(gen, 16_384, root[:3] - 1.0, root[3:] + 1.0, device)
    check_bvh_kernel("tri", (cols(o), cols(d), cap, *pk_tri), mcfg.t_min, mcfg.t_max,
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

    # 4. golden anchors on the card ------------------------------------------
    ref = golden.load_golden()
    anchor_launches = {}
    for name in ANCHORS:
        counters.reset()
        res = golden.check_anchor(name, ref, device)
        anchor_launches[name] = counters.read()
        phase("golden", f"{name}: max|d thumb|={res['dthumb']!r} (<= {golden.THUMB_ATOL}), "
              f"max|d mean|={res['dmean']!r} (<= {golden.MEAN_ATOL}); launches "
              f"{anchor_launches[name]}")
    want = {"mesh": "bvh_traverse/tri", "mesh-binned": "bvh_traverse/tri",
            "boxfield-kernel": "bvh_traverse/box", "book1-spherebvh": "bvh_traverse/sphere"}
    for name, key in want.items():
        if anchor_launches[name][key] == 0:
            raise AssertionError(f"anchor {name} did not launch {key}")

    # 5. main paths ------------------------------------------------------------
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
          f"iterations, launches {launches}, peak {peak} B allocated; image mean "
          f"{img.mean()!r}, std {img.std()!r}")
    chunks = spp // integrator.chunk_width(spp, cfg.chunk_cap)
    smt_launches = launches["sphere_min_t"]
    if smt_launches < iterations or iterations < chunks:
        raise AssertionError(f"sphere_min_t ran {smt_launches} times in {iterations} shade "
                             "iterations: the render did not go through the kernel")

    # mesh-200k at full size: a warm-up frame through render(), then timed
    t0 = time.perf_counter()
    render(mscene, mcam, mcfg, seed=MESH_SEED)
    torch.cuda.synchronize()
    phase("main", f"mesh-200k warm-up frame through render() in "
          f"{time.perf_counter() - t0:.3f} s")
    mesh_runs = {}
    for mode in ("entry", "never", "entry"):
        run_cfg = mcfg.replace(mesh_bin=mode) if mode == "never" else mcfg
        routes = integrator.kernel_routes(mscene, mscene.arrays, run_cfg)
        img, seconds, iterations, launches, peak = frame(mscene, mcam, run_cfg, MESH_SEED,
                                                         counters)
        mesh_runs.setdefault(routes.mesh_bin, []).append((seconds, iterations, launches))
        phase("main", f"mesh-200k {MESH_W}x{MESH_H}@{MESH_SPP}spp depth {MESH_DEPTH} "
              f"mesh_bin={routes.mesh_bin} on {card}: {seconds!r} s, "
              f"{MESH_W * MESH_H * MESH_SPP / seconds / 1e6!r} Mprimary-rays/s, "
              f"{iterations} shade iterations, launches {launches}, peak {peak} B "
              f"allocated, host compile {compile_s!r} s; image mean {img.mean()!r}, "
              f"std {img.std()!r}")
        if launches["bvh_traverse/tri"] < iterations or launches["sphere_min_t"] < iterations:
            raise AssertionError(f"mesh-200k: {launches} in {iterations} shade iterations: "
                                 "the render did not go through the kernels")
    tri_launches = mesh_runs["entry"][0][2]["bvh_traverse/tri"]

    t0 = time.perf_counter()
    ascene, acam = golden.mesh_scene(mcfg, device, n_seg=200, n_ring=24)
    torch.cuda.synchronize()
    acompile = time.perf_counter() - t0
    img, seconds, iterations, launches, peak = frame(ascene, acam, mcfg, MESH_SEED, counters)
    phase("main", f"mesh+arealight (9,600 triangles) {MESH_W}x{MESH_H}@{MESH_SPP}spp, "
          f"first frame (no warm-up) on {card}: {seconds!r} s, "
          f"{MESH_W * MESH_H * MESH_SPP / seconds / 1e6!r} Mprimary-rays/s, {iterations} "
          f"shade iterations, launches {launches}, peak {peak} B, host compile "
          f"{acompile!r} s; image mean {img.mean()!r}, std {img.std()!r}")
    if launches["bvh_traverse/tri"] < iterations:
        raise AssertionError("mesh+arealight did not go through the traversal kernel")

    if profile:
        profile_kernels(cases, mcfg.t_min, mcfg.t_max)
        for mode, runs in mesh_runs.items():
            profile_mesh_frame(mscene, mcam, mcfg.replace(mesh_bin=mode), runs[-1][0])

    bvh = "raysnail_tpu_torch/csrc/bvh_traverse.cu"
    replaces = "raysnail_tpu/ops/bvh_pallas.py:94"
    return [
        {"name": "sphere_min_t", "route": "cuda",
         "source": "raysnail_tpu_torch/csrc/sphere_min_t.cu",
         "replaces": "raysnail_tpu/ops/sphere_pallas.py:30",
         "launches": smt_launches, "max_abs_err": smt_err,
         "ms": res_a["ms"], "plain_ms": res_a["plain_ms"]},
        {"name": "bvh_traverse/tri", "route": "cuda", "source": bvh, "replaces": replaces,
         "launches": tri_launches, "max_abs_err": res_tri["max_abs_err"],
         "ms": res_tri["ms"], "plain_ms": res_tri["plain_ms"]},
        {"name": "bvh_traverse/box", "route": "cuda", "source": bvh, "replaces": replaces,
         "launches": anchor_launches["boxfield-kernel"]["bvh_traverse/box"],
         "max_abs_err": res_box["max_abs_err"], "ms": res_box["ms"],
         "plain_ms": res_box["plain_ms"]},
        {"name": "bvh_traverse/sphere", "route": "cuda", "source": bvh, "replaces": replaces,
         "launches": anchor_launches["book1-spherebvh"]["bvh_traverse/sphere"],
         "max_abs_err": res_sph["max_abs_err"], "ms": res_sph["ms"],
         "plain_ms": res_sph["plain_ms"]},
    ]


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _device_events(prof) -> list:
    """The profiler's device-side (kernel and memcpy) entries: a CPU op's
    device time repeats its kernels' and is not summed again."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def profile_kernels(cases: dict, t_min, t_max, repeats: int = 5):
    """torch.profiler device time per call of each traversal kind (all kinds
    in one session, `repeats` calls each) and of one call of its plain
    version, on the inputs of phase 3."""
    from torch.profiler import ProfilerActivity, profile

    from raysnail_tpu_torch.ops import bvh_traverse as bt

    def device_ms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return _device_events(prof)

    before = dict(bt.bvh_traverse.launches)
    for kind, args in cases.items():
        bt.bvh_traverse(*args, t_min, t_max, kind=kind)  # warm-up
    events = device_ms(lambda: [bt.bvh_traverse(*args, t_min, t_max, kind=kind)
                                for kind, args in cases.items() for _ in range(repeats)])
    bt.bvh_traverse.launches = before  # profiling launches are not the main path's
    for kind, args in cases.items():
        tag = f"bvh_traverse_kernel<{bt._KIND_ID[kind]}>"
        mine = [e for e in events if tag in e.key]
        calls = sum(e.count for e in mine)
        per_call = sum(_dev_us(e) for e in mine) / 1e3 / max(calls, 1)
        plain = device_ms(lambda: bt.bvh_traverse_plain(*args, t_min, t_max, kind=kind))
        phase("profile", f"bvh_traverse {kind}, N={args[0][0].shape[0]}: kernel "
              f"{per_call!r} ms device time per call ({calls} calls seen); plain version "
              f"{sum(_dev_us(e) for e in plain) / 1e3!r} ms device time in "
              f"{sum(e.count for e in plain)} kernels")


def profile_mesh_frame(scene, camera, cfg, wall_s: float):
    """torch.profiler over one mesh-200k frame with cfg's binning: device
    time by kernel, the traversal kernel's share, and the busy share against
    the unprofiled frame's wall time `wall_s`."""
    from torch.profiler import ProfilerActivity, profile

    from raysnail_tpu_torch.render import make_frame_step

    step = make_frame_step(scene, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, iterations = step(scene.arrays, camera, MESH_SEED)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0

    events = _device_events(prof)
    total = sum(_dev_us(e) for e in events)
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    phase("profile", f"mesh-200k frame, mesh_bin={cfg.mesh_bin}, under the profiler: "
          f"{iterations} iterations, "
          f"{prof_wall:.3f} s wall, device time {total / 1e3:.3f} ms, "
          f"{launches} cudaLaunchKernel calls")
    for e in sorted(events, key=_dev_us, reverse=True)[:20]:
        phase("profile", f"  {_dev_us(e) / 1e3:10.3f} ms  {100 * _dev_us(e) / total:6.2f}%  "
              f"x{e.count:<7d} {e.key[:90]}")
    bvh = sum(_dev_us(e) for e in events if "bvh_traverse_kernel" in e.key)
    smt = sum(_dev_us(e) for e in events if "sphere_min_t_kernel" in e.key)
    phase("profile", f"bvh_traverse kernel {bvh / 1e3:.3f} ms ({100 * bvh / total:.2f}% of "
          f"device time), sphere_min_t {smt / 1e3:.3f} ms ({100 * smt / total:.2f}%); "
          f"device busy {100 * total / 1e6 / wall_s:.2f}% of the unprofiled frame's "
          f"{wall_s:.3f} s wall")


if __name__ == "__main__":
    sys.exit(main())
