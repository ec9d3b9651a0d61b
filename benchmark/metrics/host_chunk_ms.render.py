"""Host milliseconds an eval chunk takes on the main thread (the
``render.chunk`` spans over their count). None where the program recorded
no spans."""

from benchmark import spans


def read(t):
    if t.unit != "chunk":
        return None
    return spans.ms_per(t, ("render.chunk",), "render.chunk")
