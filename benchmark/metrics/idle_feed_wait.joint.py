"""The device's idle share of the traced window while the main thread
waited for the feed worker's next joint batch (``joint.feed_wait``):
``benchmark/spans_joint.py``. None where the program recorded no spans."""

from benchmark import spans_joint


def read(t):
    if t.unit != "joint_step":
        return None
    return spans_joint.idle_share(t, ("joint.feed_wait",))
