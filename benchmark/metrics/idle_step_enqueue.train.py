"""The device's idle share of the traced window while the main thread was
inside a training step (``train.step`` and the spans it nests: the host
enqueueing the step's launches, or waiting inside it):
``benchmark/spans.py``. None where the program recorded no spans."""

from benchmark import spans


def read(t):
    if t.unit != "step":
        return None
    return spans.idle_share(t, ("train.step",))
