"""The MLP backward's share of its roofline in the joint stage: 2 × the
forward FLOPs of each pass with a gradient (the fine VF and colour passes,
the supervision block's VF passes spread over the steps) over (the device
seconds of the window's GEMM kernels (cuBLAS and CUTLASS products, matched
by name) × the float32-grade peak). None where no product ran."""

PATTERN = r"gemm|gemv|xmma|cutlass|splitKreduce"


def read(t):
    if t.unit != "joint_step" or "mlp_backward" not in t.work:
        return None
    seconds = t.kernel_seconds(PATTERN)
    if seconds <= 0.0:
        return None
    return 100.0 * t.work["mlp_backward"] * t.units / (
        seconds * t.peaks["f32_grade_flops"])
