"""The shipped conf with the directional-derivative loss on: the nets train
unfolded with BatchNorm on batch statistics, and the field's Jacobian at
the fine points takes three forward-mode products. Same plain reference
as ``vf_nerf``."""

from benchmark import flops
from benchmark.plain import vfnerf as reference  # noqa: F401


def work(conf: dict, traffic: dict) -> dict:
    """A step's FLOPs: the folded step's, and for each of the three tangent
    passes one more forward and backward of the VF net at the fine points
    (3 × its forward)."""
    out = flops.train_step(conf, traffic)
    fine = flops.step_rays(traffic) * (conf["ray_sampler"]["n_samples"] +
                                       traffic["fine_count"])
    out["step"] += 3 * 3 * 2 * fine * flops.vf_macs(conf)
    return out
