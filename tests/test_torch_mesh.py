"""The port's mesh, box-field and sphere-BVH renders against the JAX
package's, on the CPU.

  * The `mesh` and `mesh-binned` anchor scenes (a 1,440-triangle torus knot,
    a ground sphere and a sphere light, 96x64@4spp, depth 4, seed 7) through
    both packages. `mesh` takes the dense triangle sweep in both; the
    forced kernel route of `mesh-binned` runs the traversal kernel's plain
    version (port) and the interpret-mode TPU kernel (JAX), both with
    entry-octant binning. Every draw is keyed by (seed, pixel, sample,
    bounce, purpose) in both packages, so the two renders trace the same
    paths. Tolerances as in test_torch_render.py, per pixel and channel,
    gamma off: |d| <= 1e-4 on at least 99% of the pixels and the global mean
    of each channel within 1e-4.
  * The seven anchors the port holds (example.sdl, mesh, mesh-binned,
    boxfield-kernel, book1-spherebvh, book1, cornell) against
    tests/golden/golden.npz, with the JAX package's check_anchor tolerances
    (thumb 0.01, mean 0.003). `cornell` holds since the oriented primitives'
    world -> object transform rounds its dot products where the JAX
    package's compiled one does (geometry/boxes._apply_rows).
  * The kernel routing: what "auto" and "force" pick on the CPU.
"""

import numpy as np
import pytest
import torch

from raysnail_tpu.render import render as jrender
from raysnail_tpu.utils import golden as jgolden
from raysnail_tpu_torch import integrator
from raysnail_tpu_torch.ops import bvh_traverse as bt
from raysnail_tpu_torch.prelude import color as colorlib
from raysnail_tpu_torch.render import make_frame_step
from raysnail_tpu_torch.utils import golden

PIXEL_ATOL = 1e-4
PIXEL_SHARE = 0.99
MEAN_ATOL = 1e-4
_SUMS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_image(name, gamma):
    """The port's render of an anchor scene; the radiance sums are rendered
    once per scene and shared by the tests."""
    scene, camera, cfg, seed = golden.golden_configs("cpu")[name]()
    if name not in _SUMS:
        _SUMS[name] = make_frame_step(scene, cfg)(scene.arrays, camera, seed)[0]
    img = colorlib.into_color(_SUMS[name], float(cfg.effective_samples), gamma)
    return img.to_array().numpy().reshape(cfg.height, cfg.width, 3)


@pytest.mark.parametrize("name", ["mesh", "mesh-binned"])
def test_mesh_render_matches_jax(name):
    scene, camera, cfg, seed = jgolden.golden_configs()[name]()
    ref = jrender(scene, camera, cfg.replace(gamma=False), seed=seed)
    img = _port_image(name, gamma=False)
    assert img.shape == ref.shape and np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE, ((d <= PIXEL_ATOL).mean(), d.max())
    assert np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max() <= MEAN_ATOL


@pytest.mark.parametrize("name", ["example.sdl", "mesh", "mesh-binned", "boxfield-kernel",
                                  "book1-spherebvh", "book1", "cornell"])
def test_anchor_holds(name):
    ref = golden.load_golden()[name]
    if name.startswith("mesh"):
        fresh = golden.anchor_stats(_port_image(name, gamma=True))
        assert np.abs(fresh["thumb"] - ref["thumb"]).max() <= golden.THUMB_ATOL
        assert np.abs(fresh["mean"] - ref["mean"]).max() <= golden.MEAN_ATOL
    else:
        golden.check_anchor(name, {name: ref}, "cpu")


def test_kernel_routes_on_the_cpu():
    configs = golden.golden_configs("cpu")
    scene, _, cfg, _ = configs["mesh"]()
    auto = integrator.kernel_routes(scene, scene.arrays, cfg)
    assert not auto.mesh_kernel and auto.mesh_bin == "never" and scene.static.tri_brute
    forced = integrator.kernel_routes(scene, scene.arrays, cfg.replace(mesh_pallas="force"))
    assert forced.mesh_kernel and forced.mesh_bin == "never"
    scene, _, cfg, _ = configs["boxfield-kernel"]()
    assert integrator.kernel_routes(scene, scene.arrays, cfg).box_bvh
    assert not integrator.kernel_routes(scene, scene.arrays, cfg.replace(box_bvh="auto")).box_bvh
    scene, _, cfg, _ = configs["book1-spherebvh"]()
    assert integrator.kernel_routes(scene, scene.arrays, cfg).sphere_bvh
    assert scene.arrays.spheres.pk_bb is not None
    with pytest.raises(NotImplementedError, match="mesh_sort"):
        make_frame_step(scene, cfg.replace(mesh_sort=True))


def test_kernel_anchor_renders_never_launch_on_the_cpu():
    """On CPU tensors the traversal runs its plain version: no launch."""
    before = dict(bt.bvh_traverse.launches)
    _port_image("mesh-binned", gamma=True)
    assert bt.bvh_traverse.launches == before
