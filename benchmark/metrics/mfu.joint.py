"""The joint steps' share of the chip's float32-grade peak: the FLOPs the
traced joint steps need (the supervision block's share included) over (the
traced window's wall seconds × the peak)."""


def read(t):
    if t.unit != "joint_step" or not t.units:
        return None
    return 100.0 * t.work["step"] * t.units / (
        t.window_s * t.peaks["f32_grade_flops"])
