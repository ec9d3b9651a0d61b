"""The fused MLP kernel's share of its roofline in the joint stage: the
forward passes' FLOPs (the coarse VF, fine VF and colour passes, the
supervision block's VF passes spread over the steps) over (the device
seconds of ``fused_mlp_kernel`` × the float32-grade peak, 3 TF32 products
a float32 product). None where it did not run."""

PATTERN = r"fused_mlp_kernel[<(]"


def read(t):
    if t.unit != "joint_step":
        return None
    seconds = t.kernel_seconds(PATTERN)
    if seconds <= 0.0:
        return None
    return 100.0 * t.work["mlp_forward"] * t.units / (
        seconds * t.peaks["f32_grade_flops"])
