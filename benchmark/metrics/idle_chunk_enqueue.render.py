"""The device's idle share of the traced window while the main thread was
inside an eval chunk (``render.chunk`` and the spans it nests):
``benchmark/spans.py``. None where the program recorded no spans."""

from benchmark import spans


def read(t):
    if t.unit != "chunk":
        return None
    return spans.idle_share(t, ("render.chunk",))
