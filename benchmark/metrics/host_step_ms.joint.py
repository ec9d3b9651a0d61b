"""Host milliseconds a joint step takes on the main thread (the
``joint.step`` spans over their count), to hold against the device's
milliseconds a step. None where the program recorded no spans."""

from benchmark import spans


def read(t):
    if t.unit != "joint_step":
        return None
    return spans.ms_per(t, ("joint.step",), "joint.step")
