"""Feed-worker milliseconds a batch takes: the ``feed.assemble``,
``feed.pack`` and ``feed.copy`` spans over the batches packed, to hold
against a step's period. None where the program recorded no spans."""

from benchmark import spans

FEED = ("feed.assemble", "feed.pack", "feed.copy")


def read(t):
    if t.unit != "step":
        return None
    return spans.ms_per(t, FEED, "feed.pack")
