"""K7b's share of its roofline: the least time of every call of the rows'
select's backward in the profiled step (`rows_select_bwd*` kernels: the
segment sums, the fold and the tiles form), over their device time. A
call of N rays, R rows and K columns reads the int64 index (8 B a ray) and
K floats a ray of cotangent, writes the (R, K) gradient once, and adds N *
K floats. The shapes are recorded at the call
(`ops.rows_select.rows_select_bwd`). Moves setup_s (set-up drives the first
steps; train_mrays_per_s, which it would move, is not end to end)."""

from benchmark import roofline

KEY = "rows_select_bwd"


def _shape(grads, idx, rows):
    return idx.numel(), rows, sum(g is not None for g in grads)


def instrument(run):
    from raysnail_tpu_torch.ops import rows_select

    run.calls.wrap(rows_select, "rows_select_bwd", KEY, _shape)


def least_s(n: int, r: int, k: int) -> float:
    return roofline.least_s(n * 8 + n * k * 4 + r * k * 4, n * k)


def read(run):
    least = sum(least_s(*c) for c in run.calls.shapes[KEY])
    dev = run.trace.kernel_seconds(lambda n: "rows_select_bwd" in n)
    return roofline.share_pct(least, dev)
