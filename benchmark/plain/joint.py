"""VF-NeRF's joint pose-and-field stage in plain PyTorch: the benchmark's
reference for the joint step and the supervised step.

Written from the published method (VF-NeRF, arXiv:2408.08766; the stage's
contract, ``joint_opt_config.py:9-29`` of ``albertgassol1/vf-nerf``), not
from the program: it imports nothing of the program. The rays, the samplers,
the march and both nets (BatchNorm on its running statistics, unfolded) are
``plain/vfnerf.py``'s. Added here:

- each view's camera as ``[qw, qx, qy, qz, tx, ty, tz]``: the rotation of
  the normalised quaternion, the translation as the camera centre; each
  ray takes its view's pose by a gather, so the loss's gradient reaches
  the poses through the rays' origins and directions;
- the joint loss: ``rgb``·L1 + ``depth``·L1 clamped at
  ``depth_loss_clamp`` + ``unit_norm``·(‖n‖ − 1)² + ``similarity`` on the
  pairs (sample i, sample i + S/2) of each ray: each point should reach its
  partner by walking its unit field vector for the pair's distance; a pair
  counts where the two fields' cosine is under 0.5 and its miss over half
  the largest miss (both without gradient), weighted by 1 − cosine;
- the supervised loss: the field at surface points against their targets,
  the nearest signed basis to the field there, and at off-surface points
  against the direction to their surface point;
- Adam per group (the poses, the field) at a constant rate, no clip.

The loss turns on three discrete choices: each ray's fine window (centred
on the coarse weights' first maximum), the similarity gate (its threshold
is half the largest miss of some 100,000 pairs, and a miss turns on the
direction of the field, which rounding turns freely where the field is
near zero) and each surface point's basis. Rounding flips them, and one
flip moves the loss and its gradient by more than the rest of the
arithmetic does. So the reference can take another computation's choices
(``theirs``, read from the program's outputs): the gate as its own rule
gives it on their points and fields, and their windows and targets, each
counted where its score in the reference's own arithmetic is under
``NEAR`` of the best (a coarse weight against the ray's largest, a
target's dot with the field's direction against the largest |dot|):
rounding does not move a choice that far, and a choice made for other
rows counts too. The gate they give is held to the reference's own gate on
its own points and fields: a pair on which the two disagree counts unless
one of its tests is within ``GATE_NEAR`` of its threshold.

Noted departure: the dominant bases are the program's ``kmeans2``
clustering of its own field at surface points, a discrete choice that
rounding can move; they are an input here.

``tf32=True`` (``precision``) computes every product in TF32: the control.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.plain import vfnerf as pv
from benchmark.plain.vfnerf import (Model, Params, precision,  # noqa: F401
                                    trainable, unit)

# A choice whose score is at least this share of the best is one that
# rounding may have made.
NEAR = 0.5
# A gate test within this of its threshold (the cosine's 0.5; the miss's
# threshold, relative) is one that rounding may have flipped.
GATE_NEAR = 0.05


# ---------------------------------------------------------------- the poses
def pose_matrices(poses: torch.Tensor) -> torch.Tensor:
    """(V, 7) ``[qw, qx, qy, qz, t]`` → (V, 4, 4) camera-to-world."""
    q = unit(poses[:, :4])
    w, x, y, z = q.unbind(1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], 1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], 1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], 1)], 1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=poses.dtype,
                          device=poses.device).expand(len(poses), 1, 4)
    return torch.cat([torch.cat([rot, poses[:, 4:, None]], 2), bottom], 1)


# --------------------------------------------------------------- the choices
def window_choice(w_c: torch.Tensor, theirs: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, int]:
    """Each ray's fine-window index: the coarse weights' first maximum, or
    ``theirs``; and the count of ``theirs`` whose weight is under ``NEAR``
    of the ray's largest."""
    own = torch.argmax(w_c, dim=-1)
    if theirs is None:
        return own, 0
    if theirs.shape != own.shape:
        return own, len(own)
    top = w_c.max(-1).values
    far = w_c.gather(1, theirs[:, None])[:, 0] < NEAR * top
    return theirs, int(far.sum())


def pair_terms(x1, x2, v1, v2):
    """(miss, cosine) of the similarity pairs: each point's miss of its
    partner walking its unit field for the pair's distance, summed over
    the pair, and the cosine of the two fields."""
    n1, n2 = unit(v1), unit(v2)
    dist = (x2 - x1).norm(dim=1, keepdim=True)
    miss = (x1 - (x2 + n2 * dist)).norm(dim=1) + \
        (x2 - (x1 + n1 * dist)).norm(dim=1)
    return miss, (n1 * n2).sum(1)


def gate_of(miss: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    return (cos < 0.5) & (miss > 0.5 * miss.max())


def gate_choice(miss: torch.Tensor, cos: torch.Tensor,
                theirs: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, int, int]:
    """The similarity gate: ``gate_of`` on these pairs, or ``theirs``; the
    count of pairs where ``theirs`` and this reference's own gate disagree
    although neither test is within ``GATE_NEAR`` of its threshold (the
    cosine's 0.5, the miss's half the largest, relative), and the count of
    pairs that either gate takes."""
    own = gate_of(miss, cos)
    if theirs is None:
        return own, 0, int(own.sum())
    if theirs.shape != own.shape:
        return own, len(own), len(own)
    thr = 0.5 * miss.max()
    near = ((cos - 0.5).abs() <= GATE_NEAR) | \
        ((miss - thr).abs() <= GATE_NEAR * thr)
    return theirs, int(((theirs != own) & ~near).sum()), \
        int((theirs | own).sum())


def snap(v: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """The signed basis ±b nearest each unit vector of ``v`` (largest
    |v̂·b|; a zero dot takes +b)."""
    dots = unit(v) @ bases.t()
    best = dots.abs().argmax(1)
    sign = torch.sign(dots.gather(1, best[:, None]))
    return bases[best] * torch.where(sign == 0, torch.ones_like(sign), sign)


def snap_choice(v: torch.Tensor, bases: torch.Tensor,
                theirs: Optional[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Each point's target: this reference's ``snap``, or ``theirs``; and
    the count of ``theirs`` that are no signed basis or whose dot with v̂
    is under ``NEAR`` of the largest |v̂·b|."""
    own = snap(v, bases)
    if theirs is None:
        return own, 0
    if theirs.shape != own.shape:
        return own, len(own)
    signed = torch.cat([bases, -bases])
    is_basis = (theirs[:, None] == signed[None]).all(-1).any(1)
    best = (unit(v) @ bases.t()).abs().max(1).values
    ok = is_basis & ((unit(v) * theirs).sum(1) >= NEAR * best)
    return theirs, int((~ok).sum())


# ---------------------------------------------------------------- the render
def window_depths(z_c, idx, n_fine, fine_range, near, far, t_fine, u_extra):
    """``plain/vfnerf.py::fine_depths`` with each ray's window centred on
    the coarse depth ``idx``."""
    centre = torch.gather(z_c, 1, idx[:, None])
    step = 2.0 * fine_range / max(n_fine - 1, 1)
    offsets = step * torch.arange(n_fine, dtype=z_c.dtype, device=z_c.device)
    window = centre - fine_range + offsets[None, :]
    if t_fine is not None:
        window = pv.stratify(window, t_fine)
    extra = torch.where((idx > 0)[:, None], window,
                        u_extra * (far - near) + near)
    return torch.sort(torch.cat([z_c, extra], dim=-1), dim=-1).values


def render(model: Model, p: Params, uv, pose, intr, near, far, draws,
           n_fine: int, window: Optional[torch.Tensor] = None) -> dict:
    """``plain/vfnerf.py::render`` of one batch with a gradient and
    BatchNorm on its running statistics, each ray's fine window by
    ``window_choice`` against ``window``. Returns rgb, depth, normals and
    points, the window indices taken and the count of ``window``'s that
    are not ties."""
    conf = model.conf
    rs = conf["ray_sampler"]
    t_c, t_f, u_x = draws
    d, ud, o = pv.rays(uv, pose, intr)
    n_rays, n_c = uv.shape[0], rs["n_samples"]
    n_taps = len(conf["vf_nerf"]["cos_sim_weights"])
    taps = torch.full((n_taps,), 1.0 / n_taps, device=uv.device)
    with torch.no_grad():
        z_c = pv.coarse_depths(n_rays, n_c, near, far, t_c, uv)
        pts_c = o[:, None] + z_c[..., None] * d[:, None]
        n_cs = model.vf(p, pts_c.reshape(-1, 3), False)[:, :3]
        w_c, _, _ = pv.march(conf, pv.dens_of(p),
                             n_cs.reshape(n_rays, n_c, 3), ud, z_c, taps)
        idx, off = window_choice(w_c, window)
        z = window_depths(z_c, idx, n_fine, rs["fine_range"], near, far,
                          None if t_f is None else t_f[:, :n_fine],
                          u_x[:, :n_fine])
    s = z.shape[1]
    pts = o[:, None] + z[..., None] * d[:, None]
    flat = pts.reshape(-1, 3)
    out = model.vf(p, flat, False)
    normals = out[:, :3]
    dirs = ud[:, None].expand(-1, s, -1).reshape(-1, 3)
    rgb_s = model.colour(p, flat, normals, dirs,
                         out[:, 3:3 + model.feat], False)
    _, rgb, depth = pv.march(conf, pv.dens_of(p),
                             normals.reshape(n_rays, s, 3), ud, z, taps,
                             rgb_s.reshape(n_rays, s, 3))
    return {"rgb": rgb, "depth": depth, "normals": normals.reshape(
        n_rays, s, 3), "points": pts, "window": idx, "window_off": off}


# ----------------------------------------------------------------- the loss
def halves(pts: torch.Tensor, nrm: torch.Tensor):
    """(x1, x2, v1, v2): the pairs (sample i, sample i + S/2) of each
    ray's points ``pts`` and fields ``nrm``, (R, S, 3) each."""
    half = pts.shape[1] // 2
    return (pts[:, :half].reshape(-1, 3), pts[:, half:2 * half].reshape(-1, 3),
            nrm[:, :half].reshape(-1, 3), nrm[:, half:2 * half].reshape(-1, 3))


def similarity(miss: torch.Tensor, cos: torch.Tensor, gate: torch.Tensor):
    """The gated pairs' mean of miss · (1 − cosine); 0 where none is."""
    count = gate.sum()
    if int(count) == 0:
        return miss.sum() * 0.0
    return (miss * (1.0 - cos.detach()))[gate].sum() / count


def joint_loss(model: Model, p: Params, poses: torch.Tensor, batch: dict,
               near: float, far: float, draws, n_fine: int, weights: dict,
               clamp: float, theirs: Optional[dict] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], dict]:
    """(total, parts, choices) of one ray batch: ``batch`` holds uv (R, 2),
    view_idx (R,), intrinsics (R, 4, 4), rgb (R, 3), depth (R, 1);
    ``draws`` = (t_coarse, t_fine, u_extra); ``theirs``: the ``window``
    indices and the similarity ``gate`` to take. ``choices`` holds the
    window and gate taken, the count of ``theirs``' windows that are not
    near a maximum (``off``), and ``gate_choice``'s counts (``gate_off``,
    ``gate_pairs``)."""
    theirs = theirs or {}
    pose = pose_matrices(poses)[batch["view_idx"]]
    out = render(model, p, batch["uv"], pose, batch["intrinsics"], near, far,
                 draws, n_fine, theirs.get("window"))
    rgb = (out["rgb"] - batch["rgb"]).abs().mean()
    depth = (out["depth"][:, None] - batch["depth"]).abs().clamp(
        max=clamp).mean()
    unit_norm = ((out["normals"].norm(dim=-1) - 1.0) ** 2).mean()
    miss, cos = pair_terms(*halves(out["points"], out["normals"]))
    gate, gate_off, gate_pairs = gate_choice(miss.detach(), cos.detach(),
                                             theirs.get("gate"))
    sim = similarity(miss, cos, gate)
    total = weights["rgb"] * rgb + weights["depth"] * depth + \
        weights["unit_norm"] * unit_norm + weights["similarity"] * sim
    return total, {"rgb_loss": rgb, "depth_loss": depth,
                   "unit_norm_loss": unit_norm, "similarity_loss": sim}, \
        {"window": out["window"], "gate": gate, "off": out["window_off"],
         "gate_off": gate_off, "gate_pairs": gate_pairs}


# ---------------------------------------------------------- the supervision
def supervision_targets(model: Model, p: Params, surface: torch.Tensor,
                        off: torch.Tensor, bases: torch.Tensor,
                        theirs: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(the surface points' targets by ``snap_choice`` against the field
    ``p`` and ``theirs``, the off-surface points' directions to their
    surface points, the count of ``theirs`` that are not near the
    best)."""
    with torch.no_grad():
        field = model.vf(p, surface, False)[:, :3]
        targets, n_off = snap_choice(field, bases, theirs)
        return targets, unit(surface - off), n_off


def supervised_loss(model: Model, p: Params, surface, surface_gt, off,
                    off_gt, weights: dict
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    surf = ((model.vf(p, surface, False)[:, :3] - surface_gt) ** 2).mean()
    off_loss = ((model.vf(p, off, False)[:, :3] - off_gt) ** 2).mean()
    total = weights["supervision"] * (weights["surface"] * surf +
                                      weights["non_surface"] * off_loss)
    return total, {"surface_loss": surf, "non_surface_loss": off_loss}


# ---------------------------------------------------------------- the step
def gradients(total: torch.Tensor, leaves: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """d total / d leaf for each leaf (zeros where the loss does not reach
    it)."""
    names = list(leaves)
    got = torch.autograd.grad(total, [leaves[n] for n in names],
                              allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(names, got)}


class Adam:
    """Adam at a constant rate with no clip, over named tensors (every
    group of the stage at ``refinement_init_lr``)."""

    def __init__(self, lr: float, names: List[str], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.lr, self.names = lr, names
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu: Params = {}
        self.nu: Params = {}
        self.count = 0

    @torch.no_grad()
    def step(self, p: Params, grads: Params) -> None:
        t = self.count + 1
        for n in self.names:
            g = grads[n]
            m = self.b1 * self.mu.get(n, torch.zeros_like(g)) + \
                (1 - self.b1) * g
            v = self.b2 * self.nu.get(n, torch.zeros_like(g)) + \
                (1 - self.b2) * g * g
            self.mu[n], self.nu[n] = m, v
            p[n] = p[n] - self.lr * (m / (1 - self.b1 ** t)) / (
                torch.sqrt(v / (1 - self.b2 ** t)) + self.eps)
        self.count = t
