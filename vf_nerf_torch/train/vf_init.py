"""VF initialisation: fit the VF net to an analytic field (port of
``vf_nerf_tpu/train/vf_init.py:43-144``).

The reference starts training from pretrained VF weights
(``models/vector_field/vector_field_network.py:109-138``) that it does not
ship, so both packages regenerate them: the VF net regresses a unit target
field on points drawn uniformly in a cube of half-extent ``sample_extent``
around the centroid.

- ``center``: v(p) = normalize(centroid − p);
- ``exterior``: v(p) = normalize(p − centroid);
- ``exterior_scene``: outward inside the wall radius, inward outside it.

The net runs with BatchNorm frozen on its running statistics, as the JAX
package fits it: ``folded_weights(detach=False)`` and ``fused_mlp``, which on
the card is the kernel in its activation-save mode under ``FusedMLP``, one
launch per step. The optimizer is ``optax.adam(lr)``: Adam without a clip,
at a constant rate. The points come from ``points(step)`` when given (the
parity tests pass JAX's), else from a ``torch.Generator`` seeded with
``seed``. ``save_vf_init`` writes the ``.pkl`` of the JAX package's layout
(``{"params", "batch_stats", "mode", "radius"}``, flax names, numpy), which
``VectorFieldNerf.load_vf_init`` of either package reads.

Usage (CUDA unless ``--gpu cpu``)::

    python -m vf_nerf_torch.train.vf_init --mode exterior_scene \\
        --out data/Replica/office0/office0.pkl --radius 2.1 [--steps 2000]
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from vf_nerf_torch.config.schema import VFNetConfig
from vf_nerf_torch.models.nerf import ExponentialDecay, Optimizer, \
    resolve_device
from vf_nerf_torch.models.networks import VectorFieldMLP
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.ops.fused_mlp import fused_mlp
from vf_nerf_torch.ops.rays import normalize
from vf_nerf_torch.utils.weights import (export_jax_vf_variables,
                                         load_mlp_variables)

MODES = ("center", "exterior", "exterior_scene")


def target_field(points: torch.Tensor, mode: str, centroid: torch.Tensor,
                 wall_radius: float) -> torch.Tensor:
    rel = points - centroid
    outward = normalize(rel, dim=1)
    if mode == "center":
        return -outward
    if mode == "exterior":
        return outward
    if mode == "exterior_scene":
        r = torch.linalg.vector_norm(rel, dim=1, keepdim=True)
        return torch.where(r < wall_radius, outward, -outward)
    raise ValueError(f"unknown mode {mode}")


def default_vf_config() -> VFNetConfig:
    """The shipped conf's VF net (``confs/vf_nerf.conf:16-29``)."""
    return VFNetConfig(input_dims=3, output_dims=3, dimensions=[256] * 8,
                       feature_vector_dims=256, embedder_multires=6,
                       weight_norm=False, batch_norm=True,
                       skip_connection_in=[4], bias_init=0.0, dropout=False,
                       dropout_probability=0.2, xavier_init=False, init="")


def fit_vf_init(config: VFNetConfig,
                mode: str,
                centroid,
                sample_extent: float,
                wall_radius: float,
                steps: int = 2000,
                batch: int = 8192,
                lr: float = 1e-3,
                seed: int = 0,
                device=None,
                points: Optional[Callable[[int], torch.Tensor]] = None,
                init: Optional[Mapping] = None,
                log_every: int = 200
                ) -> Tuple[VectorFieldMLP, torch.Tensor]:
    """Train the VF net to regress the target field.

    :param points: ``points(step)`` → (batch, 3) points of that step, in
        place of the generator's draw.
    :param init: flax-layout ``{"params", "batch_stats"}`` to start from, in
        place of the seeded init.
    :return: (the fitted net on ``device``, each step's loss as a tensor on
        the device).
    """
    device = resolve_device(device)
    net = VectorFieldMLP(config, generator=torch.Generator().manual_seed(seed))
    if init is not None:
        load_mlp_variables(net, init["params"], init.get("batch_stats") or {})
    net = net.to(device).eval()
    params = {"vf": list(net.parameters())}
    optimizer = Optimizer(ExponentialDecay(lr, 1.0), clip_norm=None)
    optimizer.init(params)
    centre = torch.as_tensor(np.asarray(centroid, np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    losses = torch.empty(steps, device=device)
    for i in range(steps):
        if points is not None:
            pts = points(i).to(device, torch.float32)
        else:
            pts = centre + sample_extent * (
                torch.rand((batch, 3), generator=gen, device=device) * 2 - 1)
        target = target_field(pts, mode, centre, wall_radius)
        emb = positional_encoding(pts, config.embedder_multires)
        out = fused_mlp(net.folded_weights(detach=False), emb.contiguous(),
                        skip_at=net.skip_at, final_act="tanh")
        loss = torch.mean((out[:, :3] - target) ** 2)
        grads = torch.autograd.grad(loss, params["vf"])
        optimizer.step(params, {"vf": list(grads)})
        losses[i] = loss.detach()
        if log_every and i % log_every == 0:
            print(f"vf_init[{mode}] step {i}: loss {float(losses[i]):.5f}")
    if steps:
        print(f"vf_init[{mode}] final loss {float(losses[-1]):.5f}")
    return net, losses


def save_vf_init(path: str, net: VectorFieldMLP, mode: str,
                 radius: float) -> None:
    """The ``.pkl`` of both packages: flax-layout numpy params and batch
    statistics, the mode and the wall radius."""
    params, stats = export_jax_vf_variables(net)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats, "mode": mode,
                     "radius": radius}, f)


def main() -> None:
    parser = argparse.ArgumentParser(description="Pretrain VF init weights")
    parser.add_argument("--mode", type=str, default="exterior_scene",
                        choices=list(MODES))
    parser.add_argument("--out", type=str, required=True,
                        help="output .pkl path")
    parser.add_argument("--centroid", type=float, nargs=3,
                        default=[0.0, 0.0, 0.0])
    parser.add_argument("--radius", type=float, default=2.0,
                        help="wall radius (typically far/2)")
    parser.add_argument("--extent", type=float, default=0.0,
                        help="sampling half-extent (default 1.5 * radius)")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gpu", type=str, default="auto",
                        help="'cpu' runs on the CPU; any other value on CUDA")
    args = parser.parse_args()

    extent = args.extent if args.extent > 0 else 1.5 * args.radius
    net, _ = fit_vf_init(
        default_vf_config(), args.mode, np.asarray(args.centroid),
        sample_extent=extent, wall_radius=args.radius, steps=args.steps,
        seed=args.seed, device="cpu" if args.gpu == "cpu" else None)
    save_vf_init(args.out, net, args.mode, args.radius)
    print(f"saved VF init to {args.out}")


if __name__ == "__main__":
    main()
