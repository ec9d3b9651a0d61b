"""FLOPs that the work needs, counted from the configuration's shapes.

A dense layer of fan-in ``a`` and fan-out ``b`` needs ``a·b``
multiply-adds a point; a pass with a gradient needs 3 × its forward (the
forward, and the products for the input's and the weights' gradients). No
padded row, recomputed primal or extra pass is counted: the same work gets
the same count whatever computes it.
"""

from benchmark.plain.vfnerf import colour_widths, vf_widths


def macs(widths) -> int:
    return sum(a * b for a, b in widths)


def vf_macs(conf: dict) -> int:
    """Multiply-adds a point of the VF net (525,056 for the shipped conf)."""
    return macs(vf_widths(conf["vector_field_network"]))


def colour_macs(conf: dict) -> int:
    """Multiply-adds a point of the colour net (271,360 shipped)."""
    return macs(colour_widths(conf["rendering"]))


def step_rays(traffic: dict) -> int:
    """Rays of a training step: ``pixels_per_batch // n_views`` from each
    view."""
    n = traffic["scene"]["n_views"]
    return n * (traffic["pixels_per_batch"] // n)


def train_step(conf: dict, traffic: dict) -> dict:
    """FLOPs of one training step of the folded nets: the coarse VF pass
    without gradient; the fine VF and colour passes and the shell and ball
    VF passes with it. ``mlp_forward``: the forward passes,
    ``mlp_backward``: 2 × the forward of each pass with a gradient."""
    rays = step_rays(traffic)
    n_c = conf["ray_sampler"]["n_samples"]
    samples = n_c + traffic["fine_count"]
    vf_n, rn_n = vf_macs(conf), colour_macs(conf)
    sup = conf["vf_nerf"]
    shell_rows = (rays * samples) // 10
    shell = shell_rows * (int(sup["border_supervision"]) +
                          int(sup["center_supervision"]))
    coarse = rays * n_c * vf_n
    graded = rays * samples * (vf_n + rn_n) + shell * vf_n
    return {"step": 2 * (coarse + 3 * graded),
            "mlp_forward": 2 * (coarse + graded),
            "mlp_backward": 2 * 2 * graded}


def render_chunk(conf: dict, traffic: dict) -> dict:
    """FLOPs of one eval chunk: the coarse VF pass, the fine VF and colour
    passes, all forward."""
    rays = traffic["chunk"]
    n_c = conf["ray_sampler"]["n_samples"]
    samples = n_c + traffic["fine_count"]
    f = 2 * (rays * n_c * vf_macs(conf) +
             rays * samples * (vf_macs(conf) + colour_macs(conf)))
    return {"step": f, "mlp_forward": f}
