"""The device's idle share of the traced joint window: 1 − the union of its
kernel, copy and set intervals over the window's wall seconds."""


def read(t):
    if t.unit != "joint_step" or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
