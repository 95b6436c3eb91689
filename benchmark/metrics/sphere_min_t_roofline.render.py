"""K1's share of its roofline: the least time of every launch of the
ray x sphere kernel in the profiled slice (`sphere_min_t_kernel`), over
their device time. A launch of N rays and S spheres reads 6 floats a ray
and writes t and the index (32 B a ray), and reads 5 floats a sphere (8 and
8 in the moving form); its FP32 operations are counted as 17 a (ray,
sphere) pair (23 moving), leaving out the root's 10, which only pairs
that can hit take: the count is at most the work, so the share is at most
the true one. The shapes are recorded at the op wrapper's call
(`geometry.spheres.sphere_min_t`). Moves render_mrays_per_s."""

from benchmark import roofline

KEY = "sphere_min_t"


def _shape(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max, speed_xyz=None,
           time=None):
    return origin_xyz[0].shape[0], r2.shape[0], speed_xyz is not None


def instrument(run):
    from raysnail_tpu_torch.geometry import spheres

    run.calls.wrap(spheres, "sphere_min_t", KEY, _shape)


def least_s(n: int, s: int, moving: bool) -> float:
    return roofline.least_s(n * (8 + moving) * 4 + s * (5 + 3 * moving) * 4,
                            n * s * (17 + 6 * moving))


def read(run):
    least = sum(least_s(*c) for c in run.calls.shapes[KEY])
    dev = run.trace.kernel_seconds(lambda n: "sphere_min_t_kernel" in n)
    return roofline.share_pct(least, dev)
