"""Statistical image comparison for Monte Carlo renders.

The reference is non-deterministic (OS-seeded xorshift per thread), so
"allclose" between it and this framework must be statistical (SURVEY.md
sect.7 "stochastic equivalence"): two unbiased estimators of the same
integral agree in the mean as spp grows, with per-pixel deviations bounded
by their combined standard error.

`compare(a, b)` -> metrics dict; `assert_stochastic_match(...)` is the
quality gate used in tests: renders of the same scene from INDEPENDENT RNG
streams must agree within z-score bounds, while renders of different scenes
must not.
"""

from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = np.abs(a - b)
    return {
        "mse": mse(a, b),
        "psnr_db": psnr(a, b),
        "mean_abs": float(diff.mean()),
        "max_abs": float(diff.max()),
        "mean_a": float(a.mean()),
        "mean_b": float(b.mean()),
        "frac_within_0.05": float((diff <= 0.05).mean()),
    }


def assert_stochastic_match(a: np.ndarray, b: np.ndarray,
                            var_a: np.ndarray | None = None,
                            var_b: np.ndarray | None = None,
                            spp: int | None = None,
                            mean_tol: float = 0.01,
                            frac_tol: float = 0.95,
                            pixel_tol: float = 0.08):
    """Two independent renders of the SAME scene must satisfy:
      * global means within mean_tol,
      * >= frac_tol of pixels within pixel_tol absolute.
    When per-pixel sample variances are provided (from the accumulators), a
    z-test per pixel replaces the absolute threshold."""
    stats = compare(a, b)
    assert abs(stats["mean_a"] - stats["mean_b"]) <= mean_tol, stats
    if var_a is not None and var_b is not None and spp:
        se = np.sqrt((np.asarray(var_a) + np.asarray(var_b)) / spp) + 1e-6
        z = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / se
        frac_ok = float((z < 4.0).mean())
        assert frac_ok >= frac_tol, (frac_ok, stats)
    else:
        frac_ok = float((np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                         <= pixel_tol).mean())
        assert frac_ok >= frac_tol, (frac_ok, stats)
    return stats
