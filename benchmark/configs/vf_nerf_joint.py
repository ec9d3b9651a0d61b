"""The joint pose-and-field stage after the shipped conf's training: its
work counts and its plain reference (``benchmark/plain/joint.py``)."""

from benchmark import flops
from benchmark.plain import joint as reference  # noqa: F401

# Points of a supervision block's batches and of its bases' field: the
# runner's 4,096, ``4096 // views`` from each view.
SUPERVISION_POINTS = 4096


def supervision(conf: dict, traffic: dict) -> dict:
    """VF-net point passes of one supervision block: ``forward``, the
    passes without gradient (the bases' field, each batch's snap) and
    ``graded``, those with it (each supervised step's surface and
    off-surface points)."""
    views = traffic["scene"]["n_views"]
    points = views * (SUPERVISION_POINTS // views)
    steps = conf["joint"]["train"]["supervision_epochs"]
    return {"forward": points * (1 + steps), "graded": steps * 2 * points}


def work(conf: dict, traffic: dict) -> dict:
    """FLOPs of one joint step that the loss needs: the coarse VF pass
    without gradient, the fine VF pass with it (3 × its forward), the
    colour pass (with it, 3 × its forward, only where the joint loss weighs
    ``rgb``: at the shipped weight 0 its gradient is exactly zero, so its
    forward counts and its backward, which the program runs all the same,
    does not), and the supervision block's VF passes spread over the joint
    steps between two blocks. ``mlp_forward``: the forward passes (the
    fused MLP runs all of them), ``mlp_backward``: 2 × the forward of each
    pass whose gradient the loss needs."""
    rays = flops.step_rays(traffic)
    n_c = conf["ray_sampler"]["n_samples"]
    samples = n_c + traffic["fine_count"]
    vf_n, rn_n = flops.vf_macs(conf), flops.colour_macs(conf)
    coarse = rays * n_c * vf_n
    colour = rays * samples * rn_n
    graded = rays * samples * vf_n + \
        (colour if conf["supervised_loss_weights"]["rgb"] else 0)
    sup = supervision(conf, traffic)
    between = conf["joint"]["train"]["supervise_every"] * \
        traffic["scene"]["n_views"]
    sup_forward = sup["forward"] * vf_n / between
    sup_graded = sup["graded"] * vf_n / between
    forward = coarse + rays * samples * (vf_n + rn_n) + sup_forward + \
        sup_graded
    return {"step": 2 * forward + 4 * (graded + sup_graded),
            "mlp_forward": 2 * forward,
            "mlp_backward": 4 * (graded + sup_graded)}
