"""The bytes and operations of the port's kernels' operations, from
shapes: a frozen copy of `chip_smoke.py`'s counts at commit 3f2e19a
(`check_grid_sample`, `time_grid_bwd`, `check_ssim`). Each input is read
once and each output written once, in f32; operations at the f32 peak
outside the tensor cores. They count what the operation needs, so they
read the same work whatever kernel computes it.
"""

from .stats import bound_seconds

F32_FLOPS = 67e12


def op_work(op: str, n: int, c: int, h: int, w: int):
    """(bytes, flops) of one operation on [n, c, h, w] images at an
    output of the same size (grid [n, h, w, 2])."""
    px = n * h * w
    img = 4 * n * c * h * w
    if op == "grid_sample_fwd":
        return img + 8 * px + 4 * c * px, px * (18 + 7 * c)
    if op == "grid_sample_bwd_dgrid":
        return img + 8 * px + 4 * c * px + 8 * px, px * (30 + 14 * c)
    if op == "grid_sample_bwd_dimg":
        return 8 * px + 4 * c * px + img, px * (20 + 8 * c)
    if op == "ssim_fwd":
        return 2 * img + 4 * n * c, 100 * px * c
    if op == "ssim_bwd":
        return 4 * img + 4, 200 * px * c
    raise KeyError(f"no work counted for {op!r}")


def work_seconds(work) -> float:
    """The least seconds of a list of operations, each {"op", "count",
    "batch", "channels", "side"} (`Loop.kernel_work`)."""
    total = 0.0
    for item in work:
        nbytes, flops = op_work(item["op"], item["batch"], item["channels"], item["side"],
                                item["side"])
        total += item["count"] * bound_seconds(nbytes, flops, F32_FLOPS)
    return total
