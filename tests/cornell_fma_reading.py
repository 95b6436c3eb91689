"""Why the port does not hold the `cornell` anchor yet: a reading, not a test.

    python tests/cornell_fma_reading.py

Renders the `cornell` anchor (96x96@9spp, depth 8, seed 7) on the CPU three
times: with the port, with the JAX package as it runs by default, and with the
JAX package while XLA may not use fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX, in a process of its own). For each render it
prints the drift from the committed statistics of tests/golden/golden.npz (the
largest thumbnail block error against THUMB_ATOL, the blocks beyond it, the
mean's error) and, pair by pair, the pixels on which two renders differ by more
than 1e-4.

What it showed when the anchor was added (x86-64 with FMA, jax 0.9.0, torch
2.13.0): JAX by default reproduces the committed statistics exactly. The port
differs from it on 18 of 9,216 pixels, and one of them, (64, 50), black in the
port and 0.642 in JAX, puts thumbnail block (8, 6) at 0.010036. JAX without
fused multiply-adds differs from JAX's own default render on 12 pixels, (64, 50)
among them: the JAX package misses its own anchor there by the same block. On
11 of the port's 18 pixels JAX without fused multiply-adds gives the port's
value. So which path those pixels take is decided by whether a*b+c rounds once
or twice, in the JAX package as in the port.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
NO_FMA = "--xla_cpu_max_isa=AVX"
PIXEL_ATOL = 1e-4


def jax_render(path: str):
    """Render the anchor with the JAX package on the CPU and save it."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from raysnail_tpu.render import render
    from raysnail_tpu.utils import golden

    scene, camera, cfg, seed = golden.golden_configs()["cornell"]()
    np.save(path, np.asarray(render(scene, camera, cfg, seed=seed)))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-render":
        jax_render(sys.argv[2])
        return 0
    from raysnail_tpu_torch.utils import golden

    images = {"port": golden.render_anchor("cornell", "cpu")}
    with tempfile.TemporaryDirectory() as tmp:
        for label, flags in (("jax", None), ("jax, no fused multiply-add", NO_FMA)):
            env = dict(os.environ)
            if flags:
                env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + flags).strip()
            path = os.path.join(tmp, "image.npy")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-render", path],
                           env=env, check=True, timeout=1800)
            images[label] = np.load(path)

    ref = golden.load_golden()["cornell"]
    for label, img in images.items():
        fresh = golden.anchor_stats(img)
        block_err = np.abs(fresh["thumb"] - ref["thumb"]).max(axis=-1)
        print(f"{label}: max|d thumb| {float(block_err.max())!r} (limit {golden.THUMB_ATOL}), "
              f"blocks beyond {np.argwhere(block_err > golden.THUMB_ATOL).tolist()}, "
              f"max|d mean| {float(np.abs(fresh['mean'] - ref['mean']).max())!r} "
              f"(limit {golden.MEAN_ATOL})")
    labels = list(images)
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            d = np.abs(images[a] - images[b]).max(axis=-1)
            print(f"{a} vs {b}: {int((d > PIXEL_ATOL).sum())} of {d.size} pixels differ by more "
                  f"than {PIXEL_ATOL}: {np.argwhere(d > PIXEL_ATOL).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
