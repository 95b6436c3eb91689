"""Render configuration and reference-compatibility flags.

Field for field the same as the JAX package's `RenderConfig`, with a torch
dtype. The port runs the subset of options that its slice implements; a
value it does not implement raises where it is used (see `unsupported`).

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
    mesh_pallas: str = "auto"
    sphere_bvh: str = "auto"
    box_bvh: str = "auto"
    path_regen: str = "auto"     # "auto" = the shuffled regeneration frame step
    mesh_sort: bool = False
    mesh_bin: str = "auto"
    remat_bounces: bool = True
    regen_chunk_cap: int = 0     # cap on the regen-shuffle chunk width C;
                                 # 0 = REGEN_CHUNK_CAP
    regen_window: int = 0        # 0 = full-width cell table (the only one ported)
    rng: str = "auto"            # "auto" (= fast) | "fast"

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
        """Settings of the JAX package this port does not run yet, with the
        ROADMAP item that brings each."""
        out = []
        if self.rng not in ("auto", "fast"):
            out.append(f"rng={self.rng!r} (ROADMAP M18)")
        if self.path_regen == "never":
            out.append("path_regen='never': the sample-step path (ROADMAP M8)")
        if self.regen_window != 0:
            out.append("regen_window != 0: not ported, by decision")
        return out

