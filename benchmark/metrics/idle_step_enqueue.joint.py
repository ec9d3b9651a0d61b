"""The device's idle share of the traced window while the main thread was
inside a joint step (``joint.step`` and the spans it nests: the host
enqueueing the step's launches, or waiting inside it):
``benchmark/spans_joint.py``. None where the program recorded no spans."""

from benchmark import spans_joint


def read(t):
    if t.unit != "joint_step":
        return None
    return spans_joint.idle_share(t, ("joint.step",))
