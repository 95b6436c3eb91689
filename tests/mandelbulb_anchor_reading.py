"""The `mandelbulb` anchor's thumbnail drift under the roundings that decide
it, against the committed tests/golden/golden.npz (which the JAX package's
jitted render wrote):

    python tests/mandelbulb_anchor_reading.py [--device cpu|cuda]

  * the port as it is;
  * camera.pixel_uv's two divisions times the float32 reciprocal, which is
    how PyTorch's CUDA division by a Python number rounds them;
  * camera.pixel_uv's two divisions by a Python number (as the port wrote
    them before they took a tensor divisor: a true division on the CPU,
    the reciprocal's on the card);
  * Vec3.unit as v * torch.rsqrt(|v|^2) (as before it took 1 / sqrt:
    correctly rounded on the CPU's vector path, an approximation on the
    card);
  * both of the last two, the port as it was;
  * on the CPU only, the JAX package's own render run op by op
    (`jax.disable_jit()`, about 5 minutes).

Each line: the largest thumbnail block difference, the blocks beyond
THUMB_ATOL and the largest channel-mean difference. It imports JAX only
for the last line, so it runs on a machine without JAX with --device cuda.
"""

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raysnail_tpu_torch import camera  # noqa: E402
from raysnail_tpu_torch.prelude import rng as prng  # noqa: E402
from raysnail_tpu_torch.prelude.vec import Vec3  # noqa: E402
from raysnail_tpu_torch.utils import golden  # noqa: E402


def _offsets(px, py, s_i, s_j, sqrt_spp, keys):
    j1, j2 = prng.ray_uniforms(prng.fold_all(keys, prng.RAYGEN), 2, px.dtype)
    inv_s = 1.0 / sqrt_spp
    return px + (s_i + j1) * inv_s, py + (s_j + j2) * inv_s


def reciprocal_pixel_uv(px, py, s_i, s_j, sqrt_spp, width, height, keys):
    """camera.pixel_uv with its divisions times the float32 reciprocal."""
    xo, yo = _offsets(px, py, s_i, s_j, sqrt_spp, keys)
    return (xo * float(np.float32(1.0) / np.float32(width)),
            (height - 1.0 - yo) * float(np.float32(1.0) / np.float32(height)))


def scalar_pixel_uv(px, py, s_i, s_j, sqrt_spp, width, height, keys):
    """camera.pixel_uv with its divisions by a Python number."""
    xo, yo = _offsets(px, py, s_i, s_j, sqrt_spp, keys)
    return xo / width, (height - 1.0 - yo) / height


def rsqrt_unit(self, eps: float = 1e-20):
    """Vec3.unit through torch.rsqrt."""
    return self * torch.rsqrt(torch.clamp_min(self.length_squared(), eps))


VARIANTS = {
    "port": {},
    "camera divisions times the float32 reciprocal": {"pixel_uv": reciprocal_pixel_uv},
    "camera divisions by a Python number": {"pixel_uv": scalar_pixel_uv},
    "Vec3.unit through torch.rsqrt": {"unit": rsqrt_unit},
    "both, the port as it was": {"pixel_uv": scalar_pixel_uv, "unit": rsqrt_unit},
}


@contextlib.contextmanager
def variant(name):
    patch = VARIANTS[name]
    saved = camera.pixel_uv, Vec3.unit
    camera.pixel_uv = patch.get("pixel_uv", camera.pixel_uv)
    Vec3.unit = patch.get("unit", Vec3.unit)
    try:
        yield
    finally:
        camera.pixel_uv, Vec3.unit = saved


def drift(img, ref) -> str:
    s = golden.anchor_stats(np.asarray(img))
    blocks = np.abs(s["thumb"] - ref["thumb"]).max(axis=-1)
    return (f"max|d thumb| {float(blocks.max())!r}, {int((blocks > golden.THUMB_ATOL).sum())} "
            f"blocks beyond {golden.THUMB_ATOL}, max|d mean| "
            f"{float(np.abs(s['mean'] - ref['mean']).max())!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    ref = golden.load_golden()["mandelbulb"]
    for name in VARIANTS:
        with variant(name):
            print(f"{args.device}, {name}:",
                  drift(golden.render_anchor("mandelbulb", args.device), ref), flush=True)
    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from raysnail_tpu.utils import golden as jgolden

        with jax.disable_jit():
            print("JAX package, op by op:", drift(jgolden.render_anchor("mandelbulb"), ref),
                  flush=True)


if __name__ == "__main__":
    main()
