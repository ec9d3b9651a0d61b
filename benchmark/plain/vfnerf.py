"""VF-NeRF in plain PyTorch: the benchmark's reference for the render and the
training step.

Written from the published method (VF-NeRF, arXiv:2408.08766) and the
shipped conf's semantics, not from the program: it imports nothing of the
program and takes nothing the program made. The benchmark hands it the
inputs it handed the program (the weights it generated, the scene, the ray
batches, the state of the random generator each step or chunk drew from)
and it works the outputs out again: the rays, the samplers, both nets
(BatchNorm unfolded), the window cosine, the Laplace density, the VolSDF
weights and composite, the loss, its gradients, the clip and Adam.

The random draws are replayed from a ``torch.Generator`` state in the
order the program documents for a render chunk (``t_coarse``, ``t_fine``,
``u_extra``, each (rays, count)) and for a training step (those three, then
the shell and ball draws, (points, 3) each). With a live fine count below
the padded one, the first ``n_fine`` columns of a padded draw are the live
ones, and the arithmetic is that of the unpadded ray.

``tf32=True`` computes every product in TF32: the control, which the
comparison has to fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in TF32 (the control) or in full float32 (the reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ------------------------------------------------------------- the shapes
def embed_dim(multires: int, d: int = 3) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def vf_widths(net: dict) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of each VF layer: the layer before a skip shrinks
    its output so that the concatenation with the embedded input keeps the
    width."""
    d_in = embed_dim(net["embedder_multires"], net["input_dims"])
    dims = [d_in] + list(net["dimensions"]) + \
        [net["output_dims"] + net["feature_vector_dims"]]
    skips = list(net.get("skip_connection_in") or [])
    widths, width = [], d_in
    for i in range(len(dims) - 1):
        if i in skips:
            width += d_in
        out = dims[i + 1] - d_in if (i + 1) in skips else dims[i + 1]
        widths.append((width, out))
        width = out
    return widths


def colour_widths(net: dict) -> List[Tuple[int, int]]:
    d_in = 3 + embed_dim(net["embedder_multires"]) + 3 + \
        net["feature_vector_dims"]
    dims = [d_in] + list(net["dimensions"]) + [net["output_dims"]]
    return list(zip(dims[:-1], dims[1:]))


def layer_names(prefix: str, widths, batch_norm: bool) -> List[str]:
    """The state-dict names of a net's tensors: ``layers.{i}.0.weight`` and
    ``layers.{i}.1.*`` (BatchNorm) for every layer but the last, which is a
    plain ``layers.{i}.weight``."""
    names = []
    for i in range(len(widths)):
        if batch_norm and i < len(widths) - 1:
            names += [f"{prefix}layers.{i}.0.{k}" for k in ("weight", "bias")]
            names += [f"{prefix}layers.{i}.1.{k}" for k in
                      ("weight", "bias", "running_mean", "running_var")]
        else:
            names += [f"{prefix}layers.{i}.{k}" for k in ("weight", "bias")]
    return names


# --------------------------------------------------------------- the nets
def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """``[x, sin(x), cos(x), sin(2x), cos(2x), ...]``, whole 3-wide blocks."""
    parts = [x]
    for i in range(multires):
        parts += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(parts, dim=-1)


def mlp(p: Params, prefix: str, n_layers: int, x: torch.Tensor,
        skips, final, train_bn: bool, stats: Optional[dict]):
    """Linear → BatchNorm (running statistics, or the batch's with
    ``train_bn``) → ReLU per hidden layer; the skip layer takes
    ``[h, x] / √2``; ``final`` on the last layer's output. Batch statistics
    go into ``stats`` when it is a dict."""
    h = x
    for i in range(n_layers):
        last = i == n_layers - 1
        if i in skips:
            h = torch.cat([h, x], dim=1) / math.sqrt(2.0)
        base = f"{prefix}layers.{i}." + ("" if last else "0.")
        h = h @ p[base + "weight"].t() + p[base + "bias"]
        if not last:
            bn = f"{prefix}layers.{i}.1."
            if train_bn:
                var, mean = torch.var_mean(h, dim=0, correction=0)
                if stats is not None:
                    stats[i] = (mean.detach(), var.detach())
            else:
                mean, var = p[bn + "running_mean"], p[bn + "running_var"]
            h = (h - mean) / torch.sqrt(var + BN_EPS) * p[bn + "weight"] + \
                p[bn + "bias"]
            h = torch.relu(h)
    return final(h)


class Model:
    """The two nets and the density scalars of one configuration."""

    def __init__(self, conf: dict) -> None:
        self.conf = conf
        vf, rn = conf["vector_field_network"], conf["rendering"]
        self.vf_n = len(vf_widths(vf))
        self.rn_n = len(colour_widths(rn))
        self.skips = list(vf.get("skip_connection_in") or [])
        self.vf_multires = vf["embedder_multires"]
        self.rn_multires = rn["embedder_multires"]
        self.feat = vf["feature_vector_dims"]

    def vf(self, p, pts, train_bn, stats=None):
        return mlp(p, "vf.", self.vf_n, embed(pts, self.vf_multires),
                   self.skips, torch.tanh, train_bn, stats)

    def colour(self, p, pts, normals, dirs, feats, train_bn, stats=None):
        x = torch.cat([pts, embed(dirs, self.rn_multires), normals.detach(),
                       feats], dim=-1)
        return mlp(p, "render.", self.rn_n, x, (), torch.sigmoid, train_bn,
                   stats)


# ------------------------------------------------------------ rays, depths
def rays(uv, pose, intr):
    """(directions, unit directions, camera centres) of pixels ``uv`` (R, 2)
    under camera-to-world ``pose`` (R, 4, 4) and ``intr`` (R, 4, 4): a
    pinhole with skew; the image plane at the sign of the first ray's fy."""
    fx, fy = intr[:, 0, 0], intr[:, 1, 1]
    cx, cy, skew = intr[:, 0, 2], intr[:, 1, 2], intr[:, 0, 1]
    u, v = uv[:, 0], uv[:, 1]
    z = torch.sign(intr[0, 1, 1]) * torch.ones_like(u)
    x = (u - cx + cy * skew / fy - skew * v / fy) / fx * z.abs()
    y = (v - cy) / fy * z.abs()
    cam = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)
    world = (pose @ cam[:, :, None])[:, :3, 0]
    origin = pose[:, :3, 3]
    d = world - origin
    return d, d / d.norm(dim=-1, keepdim=True).clamp(min=1e-8), origin


def stratify(z, t):
    """Each depth jittered by ``t`` inside its mid-point interval."""
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    return lower + (upper - lower) * t


def linspace01(n, like):
    t = torch.arange(n, dtype=like.dtype, device=like.device) * (1.0 / (n - 1))
    t[-1] = 1.0
    return t


def coarse_depths(n_rays, n, near, far, t, like):
    lin = linspace01(n, like)[None, :]
    z = (near * (1.0 - lin) + far * lin).expand(n_rays, n)
    return stratify(z, t) if t is not None else z


def fine_depths(z_c, w_c, n_fine, fine_range, near, far, t_fine, u_extra):
    """The coarse depths and ``n_fine`` new ones, sorted: a stratified window
    of ±``fine_range`` around the coarse weights' first maximum, or, where
    that maximum is the first sample, uniform depths over [near, far]."""
    idx = torch.argmax(w_c, dim=-1)
    centre = torch.gather(z_c, 1, idx[:, None])
    step = 2.0 * fine_range / max(n_fine - 1, 1)
    offsets = step * torch.arange(n_fine, dtype=z_c.dtype, device=z_c.device)
    window = centre - fine_range + offsets[None, :]
    if t_fine is not None:
        window = stratify(window, t_fine)
    extra = torch.where((idx > 0)[:, None], window,
                        u_extra * (far - near) + near)
    return torch.sort(torch.cat([z_c, extra], dim=-1), dim=-1).values


# ------------------------------------------------------------ the density
def cosine(a, b):
    return (a * b).sum(-1) / (a.norm(dim=-1).clamp(min=1e-8) *
                              b.norm(dim=-1).clamp(min=1e-8))


def window_cosine(n, taps):
    """Cosines of neighbouring normals, smoothed by the window ``taps`` (W,)
    inside ``[start, L - start)``: the centre tap signed, the others by
    magnitude, all over Σ|w|; the ends keep the raw cosine."""
    x, y = n[:, :-1], n[:, 1:]
    cs = cosine(x, y)
    length, w = x.shape[1], taps.shape[0]
    start, middle = (w + 1) // 2 + 1, (w - 1) // 2
    hi = length - start
    if hi <= start:
        return cs
    norm = taps.abs().sum()
    acc = cs[:, start:hi] * taps[middle] / norm
    for i in range(1, start - 1):
        acc = acc + cosine(x[:, start:hi], y[:, start + i:hi + i]) * \
            taps[middle + i].abs() / norm
        acc = acc + cosine(x[:, start:hi], y[:, start - i - 1:hi - i - 1]) * \
            taps[middle - i].abs() / norm
    return torch.cat([cs[:, :start], acc, cs[:, hi:]], dim=1)


def laplace(x, beta, scale, mean):
    c = x - mean
    return scale * (0.5 + 0.5 * torch.sign(c) *
                    (1.0 - torch.exp(-c.abs() / beta)))


def march(conf, dens, normals, unit_dirs, z, taps, rgb=None):
    """VolSDF weights (R, S) of the field ``normals`` (R, S, 3) along the
    rays, and with per-sample colours the composite rgb and depth."""
    dc = conf["density"]
    beta = dens["beta"].clamp(*dc["beta_bounds"])
    scale = dens["scale"].abs().clamp(min=dc["scale_min"])
    mean = dens["mean"].clamp(*dc["mean_bounds"])
    # The effective truncation is -0.5: the method's density never takes
    # the conf's ``cutoff``.
    cut = laplace(torch.tensor(-0.5, device=z.device), beta, scale, mean)
    cos = window_cosine(normals, taps)
    cos_ray = cosine(normals[:, :-1],
                     unit_dirs[:, None, :].expand_as(normals[:, :-1]))
    sigma = torch.relu(laplace(-cos, beta, scale, mean) - cut)
    sigma = torch.where((cos_ray < conf["vf_nerf"]["dir_to_normal_th"]) &
                        (cos < 0), torch.zeros_like(sigma), sigma)
    sigma = torch.cat([sigma, torch.zeros_like(sigma[:, :1])], dim=1)
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], dim=1)
    fe = dists * sigma
    trans = torch.exp(-torch.cumsum(
        torch.cat([torch.zeros_like(fe[:, :1]), fe[:, :-1]], dim=1), dim=1))
    w = (1.0 - torch.exp(-fe)) * trans
    if conf["vf_nerf"]["normalize_rendering"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-5)
    if rgb is None:
        return w, None, None
    return w, (w[..., None] * rgb).sum(1), (w * z).sum(1)


# --------------------------------------------------------------- the draws
def replay_uniforms(gen, n_rays, n_coarse, n_fine_padded, perturb, device):
    """One render chunk's draws, in the program's order."""
    def rand(n):
        return torch.rand((n_rays, n), generator=gen, device=device)
    t_c = rand(n_coarse) if perturb else None
    t_f = rand(n_fine_padded) if perturb else None
    return t_c, t_f, rand(n_fine_padded)


def shell_draw(gen, n, device):
    u = torch.rand((n, 3), generator=gen, device=device)
    return u[:, 0] * (2.0 * math.pi), u[:, 1] * 2.0 - 1.0, u[:, 2]


def shell_points(draw, r_min, r_max):
    phi, cos_t, u = draw
    sin_t = torch.sqrt((1.0 - cos_t ** 2).clamp(min=0.0))
    r = u ** (1.0 / 3.0) * (r_max - r_min) + r_min
    return torch.stack([r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi),
                        r * cos_t], dim=1)


def unit(v):
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-8)


# ------------------------------------------------------------- the forward
def render(model: Model, p: Params, uv, pose, intr, near, far, draws,
           n_fine, train_bn, stats=None, grad=False):
    """The render of one batch of rays; ``draws`` = (t_coarse, t_fine,
    u_extra) with at least ``n_fine`` fine columns. Returns a dict of rgb
    (R, 3), depth (R,), normals (R, S, 3), points (R, S, 3), the flat fine
    points and the coarse weights."""
    conf = model.conf
    rs = conf["ray_sampler"]
    t_c, t_f, u_x = draws
    d, ud, o = rays(uv, pose, intr)
    n_rays, n_c = uv.shape[0], rs["n_samples"]
    taps = torch.full((len(conf["vf_nerf"]["cos_sim_weights"]),),
                      1.0 / len(conf["vf_nerf"]["cos_sim_weights"]),
                      device=uv.device)
    with torch.no_grad():
        z_c = coarse_depths(n_rays, n_c, near, far, t_c, uv)
        pts_c = o[:, None] + z_c[..., None] * d[:, None]
        n_cs = model.vf(p, pts_c.reshape(-1, 3), train_bn)[:, :3]
        w_c, _, _ = march(conf, dens_of(p), n_cs.reshape(n_rays, n_c, 3),
                          ud, z_c, taps)
        z = fine_depths(z_c, w_c, n_fine, rs["fine_range"], near, far,
                        None if t_f is None else t_f[:, :n_fine],
                        u_x[:, :n_fine]) if n_fine > 0 else z_c
    with torch.set_grad_enabled(grad):
        s = z.shape[1]
        pts = o[:, None] + z[..., None] * d[:, None]
        flat = pts.reshape(-1, 3)
        vf_stats = {} if stats is not None else None
        out = model.vf(p, flat, train_bn, vf_stats)
        normals = out[:, :3]
        feats = out[:, 3:3 + model.feat]
        dirs = ud[:, None].expand(-1, s, -1).reshape(-1, 3)
        rn_stats = {} if stats is not None else None
        rgb_s = model.colour(p, flat, normals, dirs, feats, train_bn,
                             rn_stats)
        _, rgb, depth = march(conf, dens_of(p), normals.reshape(n_rays, s, 3),
                              ud, z, taps, rgb_s.reshape(n_rays, s, 3))
    if stats is not None:
        stats["vf"], stats["render"] = vf_stats, rn_stats
    return {"rgb": rgb, "depth": depth,
            "normals": normals.reshape(n_rays, s, 3),
            "points": pts, "flat": flat, "flat_normals": normals,
            "coarse_weights": w_c}


def dens_of(p: Params) -> Params:
    return {k: p["density." + k] for k in ("beta", "scale", "mean")}


def dir_derivative_norms(model, p, flat, normals, train_bn):
    """Norms of the field's derivatives along two tangents of each normal:
    the Jacobian by three forward-mode products, each tangent one axis
    broadcast to every point (under batch statistics the tangent moves them
    too)."""
    def field(x):
        return model.vf(p, x, train_bn)[:, :3]
    cols = []
    for j in range(3):
        tangent = torch.zeros_like(flat)
        tangent[:, j] = 1.0
        cols.append(torch.func.jvp(field, (flat,), (tangent,))[1])
    jac = torch.stack(cols, dim=-1)
    t1 = torch.stack([normals[:, 1], -normals[:, 0],
                      torch.zeros_like(normals[:, 0])], dim=1)
    t2 = torch.linalg.cross(normals, t1, dim=1)
    d1 = (jac @ unit(t1)[:, :, None])[..., 0]
    d2 = (jac @ unit(t2)[:, :, None])[..., 0]
    return torch.stack([d1, d2], dim=1).reshape(-1, 3).norm(dim=-1)


def loss(model: Model, p: Params, batch, near, far, draws, shell, n_fine,
         epoch, border_radius, train_bn, stats=None):
    """The training loss of one batch: rgb L1, clamped depth L1, unit norm,
    the field's supervision (ray samples and the ball around the centroid
    point outward, the shell at the border inward), the norm hinge and the
    directional derivatives when their epochs have come."""
    conf = model.conf
    lc, lw = conf["loss"]["config"], conf["loss"]["weights"]
    out = render(model, p, batch["uv"], batch["pose"], batch["intrinsics"],
                 near, far, draws, n_fine, train_bn, stats, grad=True)
    rgb_loss = (out["rgb"] - batch["rgb"]).abs().mean()
    depth_loss = (out["depth"][:, None] - batch["depth"]).abs().clamp(
        max=lc["depth_loss_clamp"]).mean()
    norms = out["flat_normals"].norm(dim=-1)
    unit_loss = ((norms - 1.0) ** 2).mean()
    r = border_radius
    sq, count = 0.0, 0.0
    vfc = conf["vf_nerf"]
    if vfc["border_supervision"]:
        pts = shell_points(shell[0], far - 5.0 * r, far)
        sq = sq + ((model.vf(p, pts, train_bn)[:, :3] - unit(-pts)) ** 2).sum()
        count = count + pts.numel()
    if vfc["center_supervision"]:
        pts = out["points"]
        mask = (pts.norm(dim=-1) < r).to(pts.dtype)
        sq = sq + (((out["normals"] - unit(pts)) ** 2) * mask[..., None]).sum()
        count = count + mask.sum() * 3
        ball = shell_points(shell[1], 0.0, r)
        sq = sq + ((model.vf(p, ball, train_bn)[:, :3] - unit(ball)) ** 2
                   ).sum()
        count = count + ball.numel()
    sup_loss = sq / count
    total = lw["rgb"] * rgb_loss + lw["depth"] * depth_loss + \
        lw["unit_norm"] * unit_loss + lw["supervision"] * sup_loss
    if epoch >= lc["norm_smaller_than_one_start"]:
        total = total + lw["norm_smaller_than_one"] * \
            (torch.relu(norms - 1.0) ** 2).mean()
    if lw["directional_derivatives"] != 0.0 and \
            epoch >= lc["directional_derivatives_start"]:
        total = total + lw["directional_derivatives"] * dir_derivative_norms(
            model, p, out["flat"], out["flat_normals"], train_bn).mean()
    return total


# --------------------------------------------------------------- the step
class Adam:
    """Clip by the global norm, Adam, a learning rate decayed per step.
    With fine sampling the method's optimizer holds the VF net's tensors
    twice: their gradients count twice in the norm and take the clip
    coefficient squared, and Adam runs two sub-steps on them."""

    def __init__(self, conf: dict, decay_steps: int, names: List[str]):
        sc = conf["scheduler"]
        self.lr, self.clip = sc["lr"], sc["clip_norm"]
        self.gamma = sc["lr_decay_factor"] ** (1.0 / max(decay_steps, 1))
        self.twice = conf["ray_sampler"]["n_importance"] > 0
        self.mu: Params = {}
        self.nu: Params = {}
        self.count = 0
        self.names = names

    def step(self, p: Params, grads: Params) -> Params:
        """Updates ``p`` in place; returns the clipped gradients."""
        twice = {n: self.twice and n.startswith("vf.") for n in self.names}
        sq = sum((grads[n] ** 2).sum() * (2 if twice[n] else 1)
                 for n in self.names)
        norm = torch.sqrt(sq)
        if self.twice:
            coef = torch.clamp(self.clip / (norm + 1e-6), max=1.0)
            g = {n: grads[n] * (coef ** 2 if twice[n] else coef)
                 for n in self.names}
        else:
            g = {n: grads[n] if norm < self.clip else
                 grads[n] / norm * self.clip for n in self.names}
        lr = self.lr * self.gamma ** self.count
        t = self.count + 1
        with torch.no_grad():
            for n in self.names:
                steps = (2 * t - 1, 2 * t) if twice[n] else (t,)
                upd = torch.zeros_like(p[n])
                for k in steps:
                    m = self.mu.get(n, torch.zeros_like(p[n]))
                    v = self.nu.get(n, torch.zeros_like(p[n]))
                    m = 0.9 * m + 0.1 * g[n]
                    v = 0.999 * v + 0.001 * g[n] * g[n]
                    self.mu[n], self.nu[n] = m, v
                    upd = upd + (m / (1 - 0.9 ** k)) / (
                        torch.sqrt(v / (1 - 0.999 ** k)) + 1e-8)
                p[n] -= lr * upd
        self.count = t
        return g


def trainable(p: Params) -> List[str]:
    return [n for n in p if not n.split(".")[-1].startswith("running_")]


def keep_running_stats(p: Params, stats: dict) -> None:
    """The fine passes' running statistics, blended after the optimizer."""
    with torch.no_grad():
        for net in ("vf", "render"):
            for i, (mean, var) in (stats.get(net) or {}).items():
                for key, new in (("running_mean", mean), ("running_var", var)):
                    name = f"{net}.layers.{i}.1.{key}"
                    p[name] = BN_MOMENTUM * p[name] + (1 - BN_MOMENTUM) * new
