"""The device's idle share of the traced window while the main thread was
in a supervision block (``joint.supervise``: the bases' clustering and read
to the host, the batches' backprojection, the supervised steps):
``benchmark/spans_joint.py``. None where the program recorded no spans."""

from benchmark import spans_joint


def read(t):
    if t.unit != "joint_step":
        return None
    return spans_joint.idle_share(t, ("joint.supervise",))
