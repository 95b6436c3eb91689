"""K7's share of its roofline: the least time of every call of the rows'
select in the profiled slice (`rows_select_kernel`), over the kernels'
device time. A call of N rays, R rows and K columns reads the int64 index
(8 B a ray) and the table once (R * K * 4 B) and writes K floats a ray;
it does no FP32 operation. The shapes are recorded at the op wrapper's
call (`ops.rows_select.rows_select`). Moves render_mrays_per_s."""

from benchmark import roofline

KEY = "rows_select"


def _shape(columns, idx):
    return idx.numel(), columns[0].shape[0], len(columns)


def instrument(run):
    from raysnail_tpu_torch.ops import rows_select

    run.calls.wrap(rows_select, "rows_select", KEY, _shape)


def least_s(n: int, r: int, k: int) -> float:
    return roofline.least_s(n * 8 + n * k * 4 + r * k * 4, 0)


def read(run):
    least = sum(least_s(*c) for c in run.calls.shapes[KEY])
    dev = run.trace.kernel_seconds(lambda n: "rows_select_kernel" in n)
    return roofline.share_pct(least, dev)
