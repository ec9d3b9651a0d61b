"""Host milliseconds a training step takes on the main thread (the
``train.step`` spans over their count), to hold against the device's
milliseconds a step (``busy_s`` over the steps). None where the program
recorded no spans."""

from benchmark import spans


def read(t):
    if t.unit != "step":
        return None
    return spans.ms_per(t, ("train.step",), "train.step")
