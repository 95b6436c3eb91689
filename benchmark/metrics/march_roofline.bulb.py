"""K6's share of its roofline: the least time of every launch of the
Mandelbulb's march in the profiled slice (`mandelbulb_march_kernel`), over
their device time.

In the traced run the op's calls in the slice
(`ops.mandelbulb_march.mandelbulb_march`) are recorded with their rays, and
run as the program makes them. After the slice, `read` marches the same
rays again in the op's `stats=True` form, which writes each ray's march
steps, the DE iterations of its march and those of its normal: the work
these rays need, whatever order the kernel does it in. The kernel is
deterministic, so these are the counts of the timed launches.
The FP32 operations are counted from those counts as the program counts
them (`ops/mandelbulb_march.py` `operations`, from `csrc/mandelbulb_march.cu`,
compares and selects included; a division, square root, log, reciprocal,
atan2 or asin as one): DE_ITER_OPS a DE iteration, DE_TAIL_OPS a DE's tail
(the guards, the log, the products, the division and the NaN select),
STEP_OPS a march step around its DE (the point, the hit and overshoot
tests, the step), CLIP_OPS a ray (the clip to the bounding sphere and the
valid test), and NORMAL_UV_OPS and six DE tails a ray that hit (the six
offset points, the unit normal and the spherical uv).
The bytes are a ray's origin, direction and active flag read and its t,
valid flag, normal, u and v written (RAY_BYTES).
The count is the work these rays take, so the share cannot pass 100%.
Moves render_mrays_per_s."""

from benchmark import roofline

KEY = "mandelbulb_march"
DE_ITER_OPS = 72
DE_TAIL_OPS = 7
STEP_OPS = 11
CLIP_OPS = 25
NORMAL_UV_OPS = 44
RAY_BYTES = 6 * 4 + 1 + 4 + 1 + 3 * 4 + 2 * 4
BLOCK_BYTES = 1 << 30  # a block of the traced run's copies of the rays


def operations(n: int, steps: int, march_iters: int, normal_iters: int, n_valid: int) -> int:
    return (n * CLIP_OPS + steps * (STEP_OPS + DE_TAIL_OPS)
            + (march_iters + normal_iters) * DE_ITER_OPS
            + n_valid * (NORMAL_UV_OPS + 6 * DE_TAIL_OPS))


def least_s(n: int, steps: int, march_iters: int, normal_iters: int, n_valid: int) -> float:
    return roofline.least_s(n * RAY_BYTES, operations(n, steps, march_iters, normal_iters,
                                                      n_valid))


def instrument(run):
    """Record a copy of each call's rays in the slice. The copies go into
    large blocks, the first made here before the slice, so the program's
    own tensors are freed and reused as in an unprofiled frame."""
    import torch

    from raysnail_tpu_torch.ops import mandelbulb_march as mm

    blocks, used = [], [0]

    def keep(t):
        n = -(-t.numel() * t.element_size() // 256) * 256
        if not blocks or used[0] + n > blocks[-1].numel():
            blocks.append(torch.empty(max(BLOCK_BYTES, n), dtype=torch.uint8, device=t.device))
            used[0] = 0
        out = blocks[-1][used[0]:used[0] + n][:t.numel() * t.element_size()]
        used[0] += n
        return out.view(t.dtype).view(t.shape).copy_(t)

    def rays(origin, direction, t_min, t_max, active=None, stats=False):
        return keep(origin), keep(direction), t_min, t_max, None if active is None else keep(active)

    keep(torch.empty(0, device=run.device))
    run.calls.wrap(mm, "mandelbulb_march", KEY, rays)


def read(run):
    import torch

    from raysnail_tpu_torch.ops import mandelbulb_march as mm

    op = mm.mandelbulb_march
    counters = dict(vars(op))  # the recount is not the program's: leave its counters
    least = 0.0
    for origin, direction, t_min, t_max, active in run.calls.shapes[KEY]:
        _, valid, _, _, _, counts = op(origin, direction, t_min, t_max, active, True)
        steps, march_iters, normal_iters = counts.sum(1, dtype=torch.int64).tolist()
        least += least_s(origin.shape[-1], steps, march_iters, normal_iters,
                         int(valid.sum()))
    vars(op).update(counters)
    dev = run.trace.kernel_seconds(lambda name: "mandelbulb_march_kernel" in name)
    return roofline.share_pct(least, dev)
