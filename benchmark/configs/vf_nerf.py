"""The shipped VF-NeRF conf: its work counts and its plain reference
(``benchmark/plain/vfnerf.py``, the method as published)."""

from benchmark import flops
from benchmark.plain import vfnerf as reference  # noqa: F401


def work(conf: dict, traffic: dict) -> dict:
    """FLOPs one unit of the traffic needs (a step or a chunk)."""
    if traffic["kind"] == "train":
        return flops.train_step(conf, traffic)
    return flops.render_chunk(conf, traffic)
