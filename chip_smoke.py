"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
drives `raysnail_tpu_torch` (never the JAX package) through five phases and
exits non-zero if any fails:

  1. device   require CUDA; print the card's name and power limit
  2. build    build every kernel of the render path from csrc/ with nvcc
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the render path's shapes and at stress shapes; CUDA-event times
  4. golden   example.sdl at 96x64@4spp, seed 7, on the card, against the
              committed anchor tests/golden/golden.npz
  5. main     the canonical frame, example.sdl at 800x500@64spp: a warm-up
              through the CLI, then a timed run of the same calls, with the
              kernel launch counts of that run

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without CUDA it exits non-zero before
printing any result.
"""

from __future__ import annotations

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
GOLDEN = os.path.join(ROOT, "tests", "golden", "golden.npz")
WIDTH, HEIGHT, SAMPLES = 800, 500, 65       # the canonical command's frame
GOLDEN_W, GOLDEN_H, GOLDEN_SPP, GOLDEN_SEED = 96, 64, 4, 7
THUMB_ATOL, MEAN_ATOL = 0.01, 0.003          # utils/golden.py check_anchor
BLOCK = 8                                    # golden thumbnail block size
TIMING_RUNS = 20


def phase(name: str, msg: str):
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median milliseconds of `fn` over `runs` launches, by CUDA events,
    after one warm-up."""
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


def check_kernel(args, t_min, t_max, label: str, time_it: bool):
    """Kernel vs plain on the same inputs: idx equal, t bit-equal (the kernel
    is built with -fmad=false, so both round every operation alike)."""
    from raysnail_tpu_torch.ops.sphere_min_t import sphere_min_t, sphere_min_t_plain

    before = sphere_min_t.launches
    t_k, i_k = sphere_min_t(*args, t_min, t_max)
    t_p, i_p = sphere_min_t_plain(*args, t_min, t_max)
    torch.cuda.synchronize()
    err = float((t_k - t_p).abs().max())
    same_idx = bool(torch.equal(i_k, i_p))
    n_hit = int((t_p < 1e30).sum())
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


def anchor_stats(img: np.ndarray):
    h, w, _ = img.shape
    hb, wb = h // BLOCK, w // BLOCK
    thumb = img[:hb * BLOCK, :wb * BLOCK].reshape(hb, BLOCK, wb, BLOCK, 3).mean(axis=(1, 3))
    return thumb, img.mean(axis=(0, 1))


def main() -> int:
    # 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "smoke run needs a CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    kernels = run(torch.device("cuda", 0), card)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def run(device: torch.device, card: str) -> list:
    """Phases 2-5 on `device`; -> the kernels' JSON records."""
    from raysnail_tpu_torch import cli, integrator
    from raysnail_tpu_torch.camera import generate_rays
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.ops import sphere_min_t as smt
    from raysnail_tpu_torch.prelude import color as colorlib
    from raysnail_tpu_torch.prelude import rng as prng
    from raysnail_tpu_torch.render import make_frame_step, render
    from raysnail_tpu_torch.sdl.driver import build_scene

    # 2. build -----------------------------------------------------------
    t0 = time.time()
    lib = smt.build(verbose=True)
    phase("build", f"sphere_min_t: {os.path.relpath(lib, ROOT)} in "
          f"{time.time() - t0:.2f} s (nvcc {' '.join(smt.NVCC_FLAGS)})")

    # 3. kernels vs plain --------------------------------------------------
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SAMPLES)
    scene, camera = build_scene(SCENE, cfg, device)
    sph = scene.arrays.spheres
    # (a) the main path's shape: example.sdl's spheres x one frame of
    # primary rays from its camera
    n_pix = WIDTH * HEIGHT
    p = torch.arange(n_pix, device=device)
    keys = prng.fold_all(prng.fast_streams(0, p), 0)
    zero = torch.zeros(n_pix, device=device)
    ray = generate_rays(camera, (p % WIDTH).float(), (p // WIDTH).float(), zero, zero,
                        cfg.sqrt_spp, WIDTH, HEIGHT, keys)
    args_a = ((ray.origin.x, ray.origin.y, ray.origin.z),
              (ray.direction.x, ray.direction.y, ray.direction.z),
              (sph.center.x, sph.center.y, sph.center.z),
              (sph.radius * sph.radius).contiguous(), sph.active)
    res_a, _ = check_kernel(args_a, cfg.t_min, cfg.t_max, "(a) example.sdl primary rays",
                            time_it=True)
    gen = torch.Generator(device=device).manual_seed(7)
    res_b, _ = check_kernel(sphere_case(gen, 100_003, 478, device), cfg.t_min, 1e30,
                            "(b) 478 random spheres, ragged rays", time_it=True)
    args_c = sphere_case(gen, 65_537, 256, device, duplicate=True)
    res_c, (t_c, i_c) = check_kernel(args_c, cfg.t_min, 1e30, "(c) duplicated spheres",
                                     time_it=False)
    hit_c = t_c < 1e30
    if int(hit_c.sum()) == 0 or bool((i_c[hit_c] % 2 == 1).any()):
        raise AssertionError("sphere_min_t (c): a tie did not go to the first index")
    phase("kernels", f"sphere_min_t (c): every tie went to the first copy "
          f"({int(hit_c.sum())} hits)")
    max_err = max(r["max_abs_err"] for r in (res_a, res_b, res_c))

    # 4. golden anchor on the card -----------------------------------------
    gcfg = RenderConfig(width=GOLDEN_W, height=GOLDEN_H, samples=GOLDEN_SPP, max_depth=8)
    gscene, gcam = build_scene(SCENE, gcfg, device)
    img = render(gscene, gcam, gcfg, seed=GOLDEN_SEED)
    golden = np.load(GOLDEN)
    thumb, mean = anchor_stats(img)
    dthumb = float(np.abs(thumb - golden["example.sdl/thumb"]).max())
    dmean = float(np.abs(mean - golden["example.sdl/mean"]).max())
    phase("golden", f"example.sdl {GOLDEN_W}x{GOLDEN_H}@{GOLDEN_SPP}spp seed "
          f"{GOLDEN_SEED}: max|d thumb|={dthumb!r} (<= {THUMB_ATOL}), "
          f"max|d mean|={dmean!r} (<= {MEAN_ATOL})")
    if not (dthumb <= THUMB_ATOL and dmean <= MEAN_ATOL):
        raise AssertionError("golden anchor for example.sdl does not hold on the card")

    # 5. main path ---------------------------------------------------------
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smt.sphere_min_t.launches = 0
    t0 = time.perf_counter()
    accum, iterations = make_frame_step(scene, cfg)(scene.arrays, camera, 0)
    img = colorlib.into_color(accum, float(cfg.effective_samples), cfg.gamma)
    img = img.to_array().reshape(HEIGHT, WIDTH, 3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = smt.sphere_min_t.launches
    peak = torch.cuda.max_memory_allocated()
    img = img.cpu().numpy()
    spp = cfg.effective_samples
    mrays = n_pix * spp / seconds / 1e6
    phase("main", f"example.sdl {WIDTH}x{HEIGHT}@{spp}spp on {card}: {seconds!r} s, "
          f"{mrays!r} Mprimary-rays/s, {iterations} shade iterations, "
          f"sphere_min_t launches {launches}, peak {peak} B allocated")
    chunks = spp // integrator.chunk_width(spp, cfg.chunk_cap)
    if launches < iterations or iterations < chunks:
        raise AssertionError(f"sphere_min_t ran {launches} times in {iterations} shade "
                             "iterations: the render did not go through the kernel")
    if not np.isfinite(img).all() or img.shape != (HEIGHT, WIDTH, 3) or img.std() < 0.01:
        raise AssertionError(f"main-path image is not finite or is flat (std {img.std()})")
    phase("main", f"image finite, mean {img.mean()!r}, std {img.std()!r}")
    return [{
        "name": "sphere_min_t", "route": "cuda",
        "source": "raysnail_tpu_torch/csrc/sphere_min_t.cu",
        "replaces": "raysnail_tpu/ops/sphere_pallas.py:30",
        "launches": launches, "max_abs_err": max_err,
        "ms": res_a["ms"], "plain_ms": res_a["plain_ms"],
    }]


if __name__ == "__main__":
    sys.exit(main())
