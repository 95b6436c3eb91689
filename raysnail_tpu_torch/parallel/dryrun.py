"""The multi-rank dry run: every sharded path on a world of ranks, at tiny
sizes (the JAX package's `dryrun_multichip`).

    python -m raysnail_tpu_torch.parallel.dryrun --ranks 4 --device cpu
    python -m raysnail_tpu_torch.parallel.dryrun --ranks 1 --device cuda

`spawn` starts the ranks: one process each (torch.multiprocessing,
"spawn"), joined in a group on a file store in a temporary directory,
gloo on the CPU and NCCL on the cards, one card a rank (NCCL takes no two
ranks on one card). A rank runs a function of this package, so that it
imports torch and the port only. Its five checks, each a collective that
every rank runs:
  1. the sharded train step (one Adam step against a sharded render);
  2. the sharded sample step on a uv-sphere mesh with mesh_pallas="force"
     (the BVH traversal kernel on the card);
  3. adaptive passes through the padded sharded step;
  4. adaptive passes whose first pass is the sharded frame step;
  5. a checkpoint written by rank 0 in mid-render and resumed, exactly.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import queue as queuelib
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.camera import build_camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.diff.params import leaves
from raysnail_tpu_torch.painter import RenderSession, RenderState
from raysnail_tpu_torch.parallel import distributed
from raysnail_tpu_torch.parallel.mesh import Mesh, _group_device, make_mesh
from raysnail_tpu_torch.parallel.sharding import (make_padded_sharded_step,
                                                  make_sharded_frame_step,
                                                  make_sharded_sample_step,
                                                  make_sharded_train_step, render_sharded)
from raysnail_tpu_torch.render import render_passes
from raysnail_tpu_torch.scene import SceneBuilder
from raysnail_tpu_torch.scenes.meshes import uv_sphere
from raysnail_tpu_torch.sdl.driver import build_scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXAMPLE = os.path.join(ROOT, "sdl", "example.sdl")
CFG = RenderConfig(width=16, height=8, samples=4, max_depth=3)  # the JAX dry run's size


# -- the ranks ---------------------------------------------------------------

def _rank_main(rank: int, n_ranks: int, device: str, init_method: str, job, args, results):
    """One rank: join the group, run job(*args), put (rank, ok, result or
    traceback) on `results`."""
    try:
        torch.set_num_threads(1)
        dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
        distributed.initialize(init_method, n_ranks, rank, dev)
        results.put((rank, True, job(*args)))
    except Exception:  # the parent reports it and stops the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(job, n_ranks: int, device: str = "cpu", args=(), timeout: float = 600.0) -> list:
    """Run job(*args) on each of n_ranks new processes joined in one group
    -> the ranks' results, by rank. job is a module-level function (it is
    pickled by name). Raises if a rank fails or the run outlasts `timeout`
    seconds; every process is ended before it returns."""
    if device == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"{n_ranks} ranks on {torch.cuda.device_count()} cards: NCCL "
                         "takes one rank a card")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="raysnail_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, device, init, job, args,
                                                      results), daemon=True)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(out) < n_ranks:
                try:
                    rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
                except queuelib.Empty:
                    raise TimeoutError(f"{n_ranks - len(out)} of {n_ranks} ranks did not "
                                       f"finish in {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n_ranks)]


# -- the checks (collectives: every rank runs each) ----------------------------

def check_train(mesh: Mesh, scene, camera, cfg: RenderConfig, target=None, optimizer=None,
                seed: int = 0) -> dict:
    """One step of the sharded train step -> its loss and parameters (numpy).
    Without a target, the target is the sharded render of the same scene
    (linear), as in the JAX package's dry run."""
    if target is None:
        target = render_sharded(scene, camera, cfg.replace(gamma=False), mesh, seed=0)
    step, state, params = make_sharded_train_step(scene, camera, cfg, target, mesh,
                                                  optimizer=optimizer)
    params, state, loss = step(params, state, seed)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return {"loss": loss, "params": [x.cpu().numpy() for x in leaves(params)]}


def mesh_scene(device):
    """The JAX dry run's mesh scene: a uv-sphere of 8 x 12 under a light,
    16x8@4spp depth 2, every traversal through the BVH kernel
    (mesh_pallas="force") -> (scene, camera, cfg)."""
    v, f, n = uv_sphere(8, 12, center=(0.0, 0.0, -3.0))
    b = SceneBuilder()
    b.add(ir.Mesh(vertices=v, indices=f, normals=n,
                  material=ir.Lambertian(ir.Constant((0.6, 0.4, 0.3)))))
    b.add(ir.Sphere((3, 4, 0), 0.8, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 5.0)),
          light=True)
    cfg = RenderConfig(width=16, height=8, samples=4, max_depth=2, mesh_pallas="force")
    cam = build_camera(look_from=(0, 0, 1), look_at=(0, 0, -3), fov=50, width=cfg.width,
                       height=cfg.height, device=device)
    return b.compile(device=device), cam, cfg


def check_mesh_kernel(mesh: Mesh) -> np.ndarray:
    """The sharded sample step over the mesh scene's row-major pixels ->
    the (P, 3) sums (numpy)."""
    scene, cam, cfg = mesh_scene(mesh.device)
    py, px = np.meshgrid(np.arange(cfg.height, dtype=np.float32),
                         np.arange(cfg.width, dtype=np.float32), indexing="ij")
    step = make_sharded_sample_step(scene, cfg, mesh)
    sums = step(scene.arrays, cam, 1, np.arange(cfg.effective_samples), px.ravel(),
                py.ravel()).to_array().cpu().numpy()
    if not np.isfinite(sums).all():
        raise AssertionError("the sharded mesh-kernel path gave non-finite sums")
    return sums


def check_passes(mesh: Mesh, scene, camera, cfg: RenderConfig) -> np.ndarray:
    """render_passes with every pass through the padded sharded step."""
    img = render_passes(scene, camera, cfg, seed=1, step=make_padded_sharded_step(scene, cfg, mesh),
                        k_multiple=mesh.shape["sample"])
    if not np.isfinite(img).all():
        raise AssertionError("the sharded adaptive passes gave non-finite pixels")
    return img


def check_frame_passes(mesh: Mesh, scene, camera, cfg: RenderConfig) -> np.ndarray:
    """render_passes with the first pass through the sharded frame step and
    the redo passes through the padded sharded step."""
    frame_step = make_sharded_frame_step(scene, cfg, mesh)
    if frame_step is None:
        raise ValueError(f"the frame step does not shard {cfg.effective_samples} spp over "
                         f"{mesh.size} ranks")
    img = render_passes(scene, camera, cfg, seed=1, step=make_padded_sharded_step(scene, cfg, mesh),
                        k_multiple=mesh.shape["sample"], frame_step=frame_step)
    if not np.isfinite(img).all():
        raise AssertionError("the sharded frame pass and redo gave non-finite pixels")
    return img


def check_resume(mesh: Mesh, scene, camera, cfg: RenderConfig, ckpt_dir: str) -> dict:
    """Cancel a sharded RenderSession after its first chunk (rank 0 writes
    the checkpoint), resume it from the file in a new session on every rank
    and finish: the image must equal an uninterrupted render's within 1e-6.
    -> both images and the cells done at the checkpoint."""
    path = os.path.join(ckpt_dir, "state.npz")
    step = make_padded_sharded_step(scene, cfg, mesh)
    km = mesh.shape["sample"]
    RenderSession(scene, camera, cfg, seed=3, checkpoint_path=path if mesh.rank == 0 else None,
                  step=step, k_multiple=km).render(target=lambda done, total, img: False)
    dist.barrier()  # the file is whole before any rank reads it
    state = RenderState.load(path)
    if not 0 < state.samples_done < cfg.effective_samples:
        raise AssertionError(f"the checkpoint holds {state.samples_done} cells")
    resumed = RenderSession(scene, camera, cfg, seed=3, step=step,
                            k_multiple=km).render(resume=state)
    full = RenderSession(scene, camera, cfg, seed=3, step=step, k_multiple=km).render()
    np.testing.assert_allclose(resumed, full, atol=1e-6)
    return {"resumed": resumed, "full": full, "samples_done": state.samples_done}


# -- the dry run ---------------------------------------------------------------

def _dryrun_rank(ckpt_dir: str) -> dict:
    """One rank of the dry run: the five checks on example.sdl."""
    mesh = make_mesh()

    def say(msg: str):
        if mesh.rank == 0:
            print(f"dryrun_multichip: {msg}", flush=True)

    scene, cam = build_scene(EXAMPLE, CFG, mesh.device)
    out = {"mesh": (dict(mesh.shape), mesh.tile, mesh.sample)}
    out["train"] = check_train(mesh, scene, cam, CFG)
    say(f"mesh={mesh.shape} loss={out['train']['loss']:.6f} ok")
    out["mesh_kernel"] = check_mesh_kernel(mesh)
    say("sharded mesh-kernel path ok")
    acfg = CFG.replace(passes=2, noise_threshold=1e-4)
    out["passes"] = check_passes(mesh, scene, cam, acfg)
    say(f"adaptive passes executed on the {mesh.shape} mesh ok")
    out["frame_passes"] = check_frame_passes(mesh, scene, cam, acfg.replace(samples=16))
    say("sharded REGEN frame pass + adaptive redo ok")
    out["resume"] = check_resume(mesh, scene, cam, CFG.replace(samples=9, ray_batch=1 << 9),
                                 ckpt_dir)
    say("sharded checkpoint save/resume exact ok")
    return out


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> list:
    """The five checks of the dry run on n_ranks new ranks (gloo on the CPU,
    NCCL on the cards) -> each rank's outputs."""
    with tempfile.TemporaryDirectory(prefix="raysnail_dryrun_") as ckpt_dir:
        return spawn(_dryrun_rank, n_ranks, device, (ckpt_dir,))


# -- the outputs that tests/test_torch_sharding.py holds against the JAX package --

def sharded_outputs(shapes, builder: SceneBuilder, camera_kw: dict, cfg: RenderConfig,
                    target, optimizer, ckpt_dir: str) -> dict:
    """On one rank: for each (n_tile, n_sample) of `shapes`, a mesh and
    every sharded path's output on the builder's scene -> {shape: dict}."""
    device = _group_device()
    scene = builder.compile(device=device)
    cam = build_camera(**camera_kw, width=cfg.width, height=cfg.height, device=device)
    out = {}
    for n_tile, n_sample in shapes:
        mesh = make_mesh(n_tile, n_sample)
        cfg16 = cfg.replace(samples=16)
        frame_step = make_sharded_frame_step(scene, cfg16, mesh)
        sums, _ = frame_step(scene.arrays, cam, 5)
        res = {"coords": (mesh.tile, mesh.sample),
               "render": render_sharded(scene, cam, cfg, mesh, seed=0),
               "render16": render_sharded(scene, cam, cfg16, mesh, seed=0),
               "frame": sums.to_array().numpy(),
               "passes": check_passes(mesh, scene, cam, cfg.replace(passes=2,
                                                                    noise_threshold=1e-4)),
               "train": check_train(mesh, scene, cam, cfg, target, optimizer, seed=3),
               "train9": check_train(mesh, scene, cam, cfg.replace(samples=9), target,
                                     optimizer, seed=3)}
        sub = os.path.join(ckpt_dir, f"{n_tile}x{n_sample}")
        if mesh.rank == 0:
            os.makedirs(sub)
        res["resume"] = check_resume(mesh, scene, cam, cfg.replace(samples=9,
                                                                  ray_batch=1 << 9), sub)
        out[(n_tile, n_sample)] = res
    return out


# -- the canonical frame and train step on every rank, against one device ------

def _timed(fn, device, together: bool = True):
    """-> (fn(), wall seconds): every rank starts together (unless one rank
    runs alone), and the clock stops once this rank's device is done."""
    if together:
        dist.barrier()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def scaling_rank(width: int, height: int, samples: int, train_size: tuple,
                 repeats: int) -> dict:
    """On one rank: example.sdl's frame through the sharded frame step (a
    warm-up, then `repeats` timed), the all_reduce of its (W*H, 3) sums
    alone (host clock, median of 20), and one SGD(1.0) step of the sharded
    train step at train_size = (width, height, samples) after a warm-up
    step; then rank 0 alone runs the
    single-device frame step and train step on the same inputs, against
    which the sharded image (display colors) and gradient are held.
    -> walls, readings and the differences (rank 0's)."""
    from raysnail_tpu_torch.diff import make_train_step
    from raysnail_tpu_torch.prelude import color as colorlib
    from raysnail_tpu_torch.render import make_frame_step

    mesh = make_mesh()
    dev = mesh.device
    cfg = RenderConfig(width=width, height=height, samples=samples)
    scene, cam = build_scene(EXAMPLE, cfg, dev)
    step = make_sharded_frame_step(scene, cfg, mesh)
    _timed(lambda: step(scene.arrays, cam, 0), dev)
    walls = []
    for _ in range(repeats):
        (sums, _), t = _timed(lambda: step(scene.arrays, cam, 0), dev)
        walls.append(t)
    buf = torch.zeros_like(sums.to_array())
    reduce_s = float(np.median([_timed(lambda: dist.all_reduce(buf), dev)[1]
                                for _ in range(20)]))
    tw, th, ts = train_size
    tcfg = RenderConfig(width=tw, height=th, samples=ts)
    tscene, tcam = build_scene(EXAMPLE, tcfg, dev)
    target = np.zeros((th, tw, 3), np.float32)
    sgd = functools.partial(torch.optim.SGD, lr=1.0)
    tstep, st, p0 = make_sharded_train_step(tscene, tcam, tcfg, target, mesh, optimizer=sgd)
    _timed(lambda: tstep(p0, st, 0), dev)  # a process's first step costs seconds more
    (p1, _, loss), train_s = _timed(lambda: tstep(p0, st, 1), dev)
    out = {"mesh": mesh.shape, "frame_s": walls, "all_reduce_s": reduce_s,
           "train_s": train_s, "loss": float(loss)}
    dist.barrier()
    if mesh.rank == 0:  # the same work on this one device
        single = make_frame_step(scene, cfg)
        single_walls = []
        for _ in range(repeats):
            (ref, _), t = _timed(lambda: single(scene.arrays, cam, 0), dev, False)
            single_walls.append(t)
        spp = float(cfg.effective_samples)
        img = colorlib.into_color(sums, spp, cfg.gamma).to_array()
        out["frame_single_s"] = single_walls
        out["frame_max_abs_d"] = float((img - colorlib.into_color(ref, spp, cfg.gamma)
                                        .to_array()).abs().max())
        ostep, ost, _ = make_train_step(tscene, tcam, tcfg, target, optimizer=sgd)
        _timed(lambda: ostep(p0, ost, 0, np.arange(tcfg.effective_samples)), dev, False)
        (q1, _, single_loss), out["train_single_s"] = _timed(
            lambda: ostep(p0, ost, 1, np.arange(tcfg.effective_samples)), dev, False)
        out["train_single_loss"] = float(single_loss)
        # the gradients are p0 - p1; each leaf's largest difference over its max |g|
        out["grad_rel_d"] = max(
            float((a - b).abs().max()) / max(float((x0 - b).abs().max()), 1e-30)
            for x0, a, b in zip((x.detach() for x in leaves(p0)), leaves(p1), leaves(q1)))
    dist.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scaling", nargs=3, type=int, metavar=("W", "H", "SPP"),
                    help="instead of the checks: time example.sdl's W x H @ SPP frame "
                         "through the sharded frame step and a train step at a quarter of "
                         "the pixels and SPP/4 samples on every rank, against one device")
    args = ap.parse_args(argv)
    t0 = time.time()
    if args.scaling:
        w, h, spp = args.scaling
        res = spawn(scaling_rank, args.ranks, args.device,
                    (w, h, spp, (w // 2, h // 2, max(spp // 4, 1)), 3))
        print(json.dumps({"ranks": args.ranks, "device": args.device,
                          "per_rank": res}), flush=True)
    else:
        dryrun_multichip(args.ranks, args.device)
    print(f"dryrun_multichip: {args.ranks} rank(s) on {args.device}, "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
