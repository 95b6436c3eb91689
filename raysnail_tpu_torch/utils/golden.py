"""The golden regression anchors that the port can render.

The JAX package pins fixed-seed renders of representative scenes as
anchors (`raysnail_tpu/utils/golden.py`): a block-mean thumbnail and the
global mean and std per channel, committed in tests/golden/golden.npz. This
module defines the same anchor scenes for the port (same scene, size, spp,
depth, seed and forced kernel routes), renders them on a given device and
holds them against the committed statistics with the same tolerances. It
imports numpy and the port only, so it runs on a machine without JAX.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "golden.npz")

# thumbnail block size: 8x8 pixel means are stable to low-bit float drift but
# sensitive to any real estimator change
BLOCK = 8
THUMB_ATOL, MEAN_ATOL = 0.01, 0.003


def mesh_scene(cfg, device, n_seg: int = 60, n_ring: int = 12, mesh_solver=None):
    """The JAX package's mesh scene (its `mesh` anchor and its bench's
    mesh+arealight and mesh-200k cells): a (2,3) torus knot of about
    2 * n_seg * n_ring triangles, DiffuseMetal(400), a ground sphere and a
    sphere light -> (Scene, Camera) for cfg's size on `device`. mesh_solver
    as for SceneBuilder.compile."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.scene import SceneBuilder
    from raysnail_tpu_torch.scenes.meshes import torus_knot

    v, f, n = torus_knot(n_seg=n_seg, n_ring=n_ring)
    b = SceneBuilder()
    b.add(ir.Mesh(vertices=v, indices=f, normals=n,
                  material=ir.DiffuseMetal(400.0, ir.Constant((0.8, 0.6, 0.3)))))
    b.add(ir.Sphere((0, -1001.3, 0), 1000.0, ir.Lambertian(ir.Constant((0.4, 0.4, 0.45)))))
    b.add(ir.Sphere((4, 6, 3), 1.5, ir.DiffuseLight(ir.Constant((1.0, 0.95, 0.9)), 8.0)),
          light=True)
    b.set_background((0.05, 0.05, 0.08), (0.1, 0.12, 0.2))
    cam = build_camera(look_from=(0, 1.5, 4), look_at=(0, 0, 0), fov=45,
                       width=cfg.width, height=cfg.height, device=device)
    return b.compile(cfg.dtype, device, mesh_solver=mesh_solver), cam


def mandelbulb_scene(cfg, device):
    """The JAX package's Mandelbulb scene (its `mandelbulb` anchor and its
    bench's mandelbulb-passes4 cell): the bulb in BlinnPhong under a sphere
    light, no ground -> (Scene, Camera) for cfg's size on `device`."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add(ir.Mandelbulb(material=ir.BlinnPhong(0.3, 60.0, ir.Constant((0.8, 0.75, 0.6)))))
    b.add(ir.Sphere((3, 5, 3), 1.0, ir.DiffuseLight(ir.Constant((1.0, 0.95, 0.9)), 6.0)),
          light=True)
    b.set_background((0.2, 0.25, 0.35), (0.5, 0.6, 0.8))
    cam = build_camera(look_from=(2.2, 1.4, 2.2), look_at=(0, 0, 0), fov=45,
                       width=cfg.width, height=cfg.height, device=device)
    return b.compile(cfg.dtype, device), cam


def golden_configs(device):
    """name -> thunk returning (scene, camera, cfg, seed) on `device`, for
    the anchors the port renders."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.scene import SceneBuilder
    from raysnail_tpu_torch.scenes import book1, book2, cornell
    from raysnail_tpu_torch.sdl.driver import build_scene

    out = {}

    def sdl(name):
        def entry():
            cfg = RenderConfig(width=96, height=64, samples=4, max_depth=8)
            scene, cam = build_scene(os.path.join(REPO, "sdl", name), cfg, device)
            return scene, cam, cfg, 7
        return entry

    for name in ("example.sdl", "quadric.sdl", "csg.sdl"):
        out[name] = sdl(name)

    def cornell_entry():
        # held like every anchor, with a thin margin: its rotated carton
        # agrees because geometry/boxes._apply_rows rounds the oriented box's
        # products as XLA's CPU code fuses them
        cfg = RenderConfig(width=96, height=96, samples=9, max_depth=8)
        scene = cornell.cornell_box(carton=True, carton_rotation=True).compile(cfg.dtype, device)
        return scene, cornell.cornell_camera(cfg.width, cfg.height, device=device), cfg, 7

    out["cornell"] = cornell_entry

    def book1_entry():
        cfg = RenderConfig(width=96, height=54, samples=4, max_depth=8)
        return (book1.balls_scene(7).compile(cfg.dtype, device),
                book1.balls_camera(cfg.width, cfg.height, device=device), cfg, 7)

    out["book1"] = book1_entry

    def book2_entry():
        # 400 ground boxes (the box kernel K3 on the card), a moving sphere
        # (K1's moving form), media, an image and a Perlin texture
        cfg = RenderConfig(width=96, height=54, samples=4, max_depth=6)
        return (book2.all_feature_scene(7).compile(cfg.dtype, device),
                book2.book2_camera(cfg.width, cfg.height, device=device), cfg, 7)

    out["book2"] = book2_entry

    def mesh_entry():
        cfg = RenderConfig(width=96, height=64, samples=4, max_depth=4)
        return (*mesh_scene(cfg, device), cfg, 7)

    out["mesh"] = mesh_entry

    def bulb_entry():
        # the Mandelbulb (the march kernel K6 on the card) under a sphere light
        cfg = RenderConfig(width=80, height=48, samples=4, max_depth=4)
        return (*mandelbulb_scene(cfg, device), cfg, 7)

    out["mandelbulb"] = bulb_entry

    def book1_spherebvh_entry():
        # the book1 balls forced through the BVH kernel's sphere kind
        cfg = RenderConfig(width=64, height=36, samples=4, max_depth=4, sphere_bvh="force")
        return (book1.balls_scene(7).compile(cfg.dtype, device),
                book1.balls_camera(cfg.width, cfg.height, device=device), cfg, 7)

    out["book1-spherebvh"] = book1_spherebvh_entry

    def boxfield_entry():
        # a 144-box field forced through the BVH kernel's box kind
        cfg = RenderConfig(width=64, height=40, samples=4, max_depth=4, box_bvh="force")
        b = SceneBuilder()
        gm = ir.Lambertian(ir.Constant((0.48, 0.83, 0.53)))
        rng = np.random.default_rng(5)
        for i in range(12):
            for j in range(12):
                b.add(ir.Box((-6.0 + i, 0.0, -6.0 + j),
                             (-5.0 + i, 0.1 + 2.0 * rng.random(), -5.0 + j), gm))
        b.add(ir.Sphere((0, 6, 0), 1.0, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 5.0)),
              light=True)
        cam = build_camera(look_from=(0, 4, 9), look_at=(0, 0, 0), fov=50,
                           width=cfg.width, height=cfg.height, device=device)
        return b.compile(cfg.dtype, device), cam, cfg, 7

    out["boxfield-kernel"] = boxfield_entry

    def mesh_binned_entry():
        # the mesh scene forced through the kernel with entry-octant binning
        cfg = RenderConfig(width=96, height=64, samples=4, max_depth=4,
                           mesh_pallas="force", mesh_bin="entry")
        return (*mesh_scene(cfg, device), cfg, 7)

    out["mesh-binned"] = mesh_binned_entry
    return out


# the leaf kinds of the packet traversal kernel and the anchor that runs each
PACKET_ANCHORS = {"tri": "mesh", "tri_mxu": "mesh", "box": "boxfield-kernel",
                  "sphere": "book1-spherebvh"}


@contextlib.contextmanager
def traversal_env(stream=None, two_level=None):
    """Set the traversal's call-time switches for the block: `stream` on
    (RAYSNAIL_BVH_STREAM_BYTES=0) or off (a threshold no scene reaches),
    `two_level` on or off (RAYSNAIL_BVH_TWO_LEVEL); None leaves a switch as
    it is. The environment is restored after."""
    want = {}
    if stream is not None:
        want["RAYSNAIL_BVH_STREAM_BYTES"] = "0" if stream else str(1 << 62)
    if two_level is not None:
        want["RAYSNAIL_BVH_TWO_LEVEL"] = "1" if two_level else "0"
    before = {name: os.environ.get(name) for name in want}
    os.environ.update(want)
    try:
        yield
    finally:
        for name, value in before.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value


def forced_mode_configs(device):
    """name -> (thunk, stream, two_level): each anchor above forced through
    the packet traversal kernel in every mode, "<anchor>/packet/<kind>
    [+stream][+two_level]"; the render runs under `traversal_env(stream,
    two_level)`. The modes change no result (tri_mxu: beyond its rounding),
    so each is held against its anchor's committed statistics."""
    base = golden_configs(device)
    out = {}
    for kind, anchor in PACKET_ANCHORS.items():
        for stream in (False, True):
            for two_level in (False, True):
                def thunk(kind=kind, anchor=anchor):
                    if anchor == "mesh":
                        cfg = base[anchor]()[2]
                        scene, cam = mesh_scene(
                            cfg, device, mesh_solver="mxu" if kind == "tri_mxu" else "cramer")
                        cfg, seed = cfg.replace(mesh_pallas="force"), 7
                    else:
                        scene, cam, cfg, seed = base[anchor]()
                    return scene, cam, cfg.replace(bvh_packet="force"), seed
                name = (f"{anchor}/packet/{kind}" + ("+stream" if stream else "")
                        + ("+two_level" if two_level else ""))
                out[name] = (thunk, stream, two_level)
    return out


def render_anchor(name: str, device="cuda") -> np.ndarray:
    """Render anchor `name`, or one of `forced_mode_configs`' entries."""
    from raysnail_tpu_torch.render import render

    entries = golden_configs(device)
    thunk, *modes = (entries[name],) if name in entries else forced_mode_configs(device)[name]
    scene, camera, cfg, seed = thunk()
    with traversal_env(*modes):
        return render(scene, camera, cfg, seed=seed)


def anchor_stats(img: np.ndarray) -> dict:
    """Block-mean thumbnail + global stats for one render."""
    h, w, _ = img.shape
    hb, wb = h // BLOCK, w // BLOCK
    thumb = img[:hb * BLOCK, :wb * BLOCK].reshape(hb, BLOCK, wb, BLOCK, 3).mean(axis=(1, 3))
    return {"thumb": thumb.astype(np.float32),
            "mean": img.mean(axis=(0, 1)).astype(np.float32),
            "std": img.std(axis=(0, 1)).astype(np.float32)}


def load_golden() -> dict:
    """-> {name: stats dict} from the committed archive."""
    data = np.load(GOLDEN_PATH)
    names = sorted({k.split("/")[0] for k in data.files})
    return {n: {f: data[f"{n}/{f}"] for f in ("thumb", "mean", "std")} for n in names}


def anchor_drift(name: str, golden: dict, device="cuda") -> dict:
    """Render `name` on `device` -> its drift from the committed stats:
    {"dthumb", "dmean", "blocks_beyond" (thumbnail blocks past THUMB_ATOL)}."""
    fresh = anchor_stats(render_anchor(name, device))
    ref = golden[name.split("/")[0]]  # a forced-mode entry is held to its anchor
    assert fresh["thumb"].shape == ref["thumb"].shape, (
        f"{name}: thumbnail shape {fresh['thumb'].shape} vs {ref['thumb'].shape}")
    block_err = np.abs(fresh["thumb"] - ref["thumb"]).max(axis=-1)
    return {"dthumb": float(block_err.max()),
            "dmean": float(np.abs(fresh["mean"] - ref["mean"]).max()),
            "blocks_beyond": int((block_err > THUMB_ATOL).sum())}


def check_anchor(name: str, golden: dict, device="cuda") -> dict:
    """Render `name` on `device` and hold it against its committed stats
    within THUMB_ATOL and MEAN_ATOL -> its `anchor_drift`; raises
    AssertionError on drift."""
    res = anchor_drift(name, golden, device)
    assert res["dthumb"] <= THUMB_ATOL, (
        f"{name}: thumbnail drifted by {res['dthumb']} (> {THUMB_ATOL})")
    assert res["dmean"] <= MEAN_ATOL, (
        f"{name}: global mean drifted by {res['dmean']} (> {MEAN_ATOL})")
    return res
