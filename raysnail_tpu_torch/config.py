"""Render configuration and reference-compatibility flags.

Field for field the same as the JAX package's `RenderConfig`, with a torch
dtype. The port runs every option of the forward render but those it
leaves out by decision; such a value raises where it is used (see
`unsupported`).

Reference quirks covered (file:line cites into the Rust reference):
  * hardcoded 1/pi light-branch pdf         src/camera.rs:199
  * HittablePdf value() falls back to a cosine pdf, not solid angle
                                            src/prelude/pdf.rs:254-263
  * effective spp = floor(sqrt(n))**2       src/painter.rs:110-118
  * adaptive-noise 5x5 window column bug    src/bin/raysnail.rs:163
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# default chunk width of the shuffled regeneration integrator's cell table
# (the largest divisor of spp <= this cap)
REGEN_CHUNK_CAP = 21


def entry_device(device="cuda") -> torch.device:
    """The device of a library entry point: the card, unless the caller
    names another. Asking for the card where there is none raises; nothing
    falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for, but no CUDA device is available; "
                           "pass device=\"cpu\" to run the plain PyTorch versions")
    return dev


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the renderer (hashable Python values)."""

    # Image / sampling -----------------------------------------------------
    width: int = 800
    height: int = 500
    samples: int = 65           # requested spp; effective spp may round down
    max_depth: int = 8          # bounce budget (reference default: camera.rs:117)
    gamma: bool = True          # sqrt gamma on output (vec3.rs:225-240)

    # Numerics -------------------------------------------------------------
    dtype: Any = torch.float32
    t_min: float = 1e-3         # reference uses 1e-4 in f64 (camera.rs:165)
    t_max: float = 3e4          # reference uses +inf; bounded for f32
    shadow_eps: float = 2e-3    # reference: 0.0002 in f64 (camera.rs:211)

    # Estimator ------------------------------------------------------------
    light_sample_prob: float = 0.5   # 50/50 light-vs-BSDF split (camera.rs:194)
    compat_light_pdf: bool = True    # light branch pdf := 1/pi (camera.rs:199)
    proper_mis: bool = False         # one-sample MIS instead of compat estimator
    russian_roulette: bool = False   # optional RR termination (off = reference parity)

    # Compat flags ---------------------------------------------------------
    compat_spp_square: bool = True     # effective spp = floor(sqrt(n))**2
    compat_noise_bug: bool = False     # replicate the x=y 5x5 window bug

    # Execution ------------------------------------------------------------
    ray_batch: int = 1 << 25     # rays per dispatch of the sample-step path
    use_pallas: str = "auto"     # JAX package only; the port's sphere sweep
                                 # always runs its kernel on CUDA tensors
    # BVH traversal kernel routes (integrator.kernel_routes): "auto" takes
    # the kernel on CUDA (sphere groups from 4096 spheres), the dense or
    # brute routes on the CPU; "force" always takes the kernel route; any
    # other value keeps the dense routes
    mesh_pallas: str = "auto"
    sphere_bvh: str = "auto"
    box_bvh: str = "auto"
    # the packet traversal kernel (ops.bvh_traverse): "auto" takes it when
    # the call needs it (a "tri_mxu" mesh, stream by RAYSNAIL_BVH_STREAM_BYTES,
    # two_level by RAYSNAIL_BVH_TWO_LEVEL), "force" always, "never" refuses
    # such a call. A field of the port only: the JAX package has one kernel.
    bvh_packet: str = "auto"
    path_regen: str = "auto"     # "auto" = path regeneration (the shuffled frame
                                 # step, the sample step's per-pixel loop) with
                                 # the fast RNG; "never" = the per-sample scan
                                 # integrator (integrator.radiance)
    mesh_sort: bool = False      # not ported, by decision (ROADMAP "Not to port")
    mesh_bin: str = "auto"       # ray binning ahead of the mesh kernel: "auto"
                                 # (= "entry" on CUDA, else "never") | "never" |
                                 # "entry" | "dir" | "entrydir" | "miss"
    remat_bounces: bool = True
    regen_chunk_cap: int = 0     # cap on the regen-shuffle chunk width C;
                                 # 0 = REGEN_CHUNK_CAP
    regen_window: int = 0        # 0 = full-width cell table (the only one ported)
    rng: str = "auto"            # "auto" (= fast) | "fast" (counter hash) | "threefry"
                                 # (jax.random's keys; the scan integrator)

    # Adaptive oversampling (multi-pass) ------------------------------------
    passes: int = 1
    noise_threshold: float = 0.01    # raysnail.rs:405

    @property
    def sqrt_spp(self) -> int:
        """Stratification grid edge; reference painter.rs:110-118."""
        return max(1, int(math.isqrt(self.samples)))

    @property
    def effective_samples(self) -> int:
        if self.compat_spp_square:
            return self.sqrt_spp * self.sqrt_spp
        return self.samples

    @property
    def chunk_cap(self) -> int:
        return self.regen_chunk_cap or REGEN_CHUNK_CAP

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def unsupported(self) -> list[str]:
        """Settings this port cannot run: those of the JAX package that it
        leaves out by decision (ROADMAP "Not to port"), and values no
        package takes."""
        out = []
        if self.rng not in ("auto", "fast", "threefry"):
            out.append(f"rng={self.rng!r}: not 'auto', 'fast' or 'threefry'")
        if self.bvh_packet not in ("auto", "force", "never"):
            out.append(f"bvh_packet={self.bvh_packet!r}: not 'auto', 'force' or 'never'")
        if self.passes < 1:
            out.append(f"passes={self.passes}: at least 1")
        if not self.noise_threshold >= 0.0:
            out.append(f"noise_threshold={self.noise_threshold}: not >= 0")
        if self.regen_window != 0:
            out.append("regen_window != 0: not ported, by decision (ROADMAP 'Not to port')")
        if self.mesh_sort:
            out.append("mesh_sort=True: not ported, by decision (ROADMAP 'Not to port')")
        if self.mesh_bin not in ("auto", "never", "entry", "dir", "entrydir", "miss"):
            out.append(f"mesh_bin={self.mesh_bin!r}: no such binning mode")
        return out

