"""The device's idle share of the traced window while the main thread was
at an epoch's edge: its start up to the first step (``train.epoch_start``),
the epoch-end copy and the previous epoch's read (``train.epoch_read``),
the dataset's image resampling (``train.sample_images``):
``benchmark/spans.py``. None where the program recorded no spans."""

from benchmark import spans


def read(t):
    if t.unit != "step":
        return None
    return spans.idle_share(t, ("train.epoch_start", "train.epoch_read",
                                "train.sample_images"))
