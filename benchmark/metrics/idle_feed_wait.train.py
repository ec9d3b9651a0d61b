"""The device's idle share of the traced window while the main thread
waited for the feed worker's next batch (``train.feed_wait``):
``benchmark/spans.py``. None where the program recorded no spans."""

from benchmark import spans


def read(t):
    if t.unit != "step":
        return None
    return spans.idle_share(t, ("train.feed_wait",))
