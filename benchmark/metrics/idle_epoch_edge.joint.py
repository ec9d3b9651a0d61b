"""The device's idle share of the traced window while the main thread read
a joint epoch's sums to the host (``joint.epoch_read``, which waits for the
epoch's last step): ``benchmark/spans_joint.py``. None where the program
recorded no spans."""

from benchmark import spans_joint


def read(t):
    if t.unit != "joint_step":
        return None
    return spans_joint.idle_share(t, ("joint.epoch_read",))
