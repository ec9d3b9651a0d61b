"""Vector-field and rendering MLPs as ``nn.Module``s (port of
``vf_nerf_tpu/models/networks.py``; reference
``models/vector_field/vector_field_network.py:14-208`` and
``models/vector_field/rendering_network.py:13-108``).

- ``VectorFieldMLP``: PE(multires) on xyz, hidden layers with ReLU, the
  embedded input re-concatenated at each layer of ``skip_connection_in`` and
  divided by √2 (the layer before it shrinks its output so the width stays),
  tanh over all outputs ``[vf(3) | features]``.
- ``RenderingMLP``: IDR-style colour net on ``[xyz, PE(view), normals,
  features]``, ReLU hidden, sigmoid out.

Each layer is ``layers.{i}`` = ``nn.Sequential(Linear, BatchNorm1d)`` when
it has BatchNorm (every layer but the last, and none with weight norm), a
``WeightNormLinear`` with weight norm, else a plain ``nn.Linear`` — exactly
the reference state-dict layout (``layers.{i}.0.weight``,
``layers.{i}.1.running_mean``, ``layers.{i}.weight_g``,
``layers.{i}.weight``), so reference ``.pth`` files load as they are. Init
is torch's default Linear init, U(±1/√fan_in), or Xavier with a constant
bias when ``xavier_init`` (not for weight norm, whose ``v`` takes torch's
init and ``g = ‖v‖``, as in the JAX package).

``forward(..., train)`` returns ``(out, updates)``. BatchNorm follows
flax's semantics, not ``nn.BatchNorm1d``'s: in eval mode it runs on the
running statistics; in train mode it normalizes with the batch mean and the
biased batch variance, and ``updates`` holds the new running statistics,
``0.9·running + 0.1·batch`` of the mean and of the biased variance, under
the state-dict names. The forward never writes a buffer: the caller keeps
the updates of the pass it chooses (``apply_updates``), as the JAX package
keeps only the fine pass's. Data parallel (``parallel/mesh.py``), the
batch is the global one: the row count and the row sums are summed over
the ranks, then the squared deviations from the global mean (two passes,
as ``torch.var_mean``), so every rank normalizes and updates with the
statistics of the whole batch, as flax does under GSPMD. Dropout in train
mode raises
``NotImplementedError``: the JAX renderer passes no ``dropout`` rng, so the
JAX package cannot train with it either (in eval mode it is the identity
in both).

``vf_jacobian`` (three forward-mode JVPs, each tangent one basis vector
broadcast to every point), ``numerical_vf_jacobian`` (central differences)
and ``directional_derivatives`` are the JAX package's. Under train-mode
BatchNorm a broadcast tangent also moves the batch statistics, so the JVP
carries their terms: the JAX package's Jacobian, not the reference's
per-row reverse-mode rows (``ROADMAP.md`` §C).

``compute_dtype`` (bfloat16 or float16; None is float32) is flax's mixed
precision, as the JAX nets take it: each Linear casts its input, weight
and bias to that dtype and returns it; BatchNorm normalizes in float32
(flax's ``force_float32_reductions``: the statistics and the running
update in float32) and returns the compute dtype; weight norm's layers
take no dtype in the JAX package (its ``WeightNormDense``), so they stay
in float32; the skip concatenation promotes to float32, as
``jnp.concatenate`` does; and each net casts its output back to its
input's dtype. Parameters stay float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vf_nerf_torch.config.schema import RenderingNetConfig, VFNetConfig
from vf_nerf_torch.ops.embedding import embedding_dim, positional_encoding
from vf_nerf_torch.ops.fused_mlp import Weights, fold_dense_bn
from vf_nerf_torch.parallel.mesh import all_reduce_sum, global_sum, sharded

# flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, the JAX package's:
# running = momentum·running + (1 − momentum)·batch.
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
Updates = Dict[str, torch.Tensor]


class WeightNormLinear(nn.Module):
    """A Linear under weight norm, in torch ``weight_norm(dim=0)``'s layout:
    ``weight_v`` (out, in), ``weight_g`` (out, 1), ``bias`` (out,), and
    ``W = v · g / max(‖v‖, 1e-12)`` with the norm of each output's row over
    the input dimension (JAX ``WeightNormDense``)."""

    def __init__(self, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator]) -> None:
        super().__init__()
        bound = 1.0 / fan_in ** 0.5
        v = torch.empty(fan_out, fan_in).uniform_(-bound, bound,
                                                  generator=generator)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            torch.linalg.vector_norm(v, dim=1, keepdim=True))
        self.bias = nn.Parameter(torch.empty(fan_out).uniform_(
            -bound, bound, generator=generator))

    @property
    def weight(self) -> torch.Tensor:
        """The effective (out, in) weight, on the autograd graph."""
        norm = torch.linalg.vector_norm(self.weight_v, dim=1, keepdim=True)
        return self.weight_v * (self.weight_g / torch.clamp(norm, min=1e-12))


def _linear(fan_in: int, fan_out: int, xavier: bool, bias_init: float,
            generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    with torch.no_grad():
        if xavier:
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.constant_(lin.bias, bias_init)
        else:
            bound = 1.0 / fan_in ** 0.5
            nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
            nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return lin


def batch_var_mean(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(biased variance, mean) over the rows of the global batch; one rank:
    ``torch.var_mean``."""
    if not sharded():
        return torch.var_mean(x, dim=0, correction=0)
    n = global_sum(torch.full((), float(x.shape[0]), device=x.device))
    mean = all_reduce_sum(torch.sum(x, dim=0)) / n
    var = all_reduce_sum(torch.sum((x - mean) ** 2, dim=0)) / n
    return var, mean


def dense_and_norm(layer: nn.Module
                   ) -> Tuple[nn.Module, Optional[nn.BatchNorm1d]]:
    """(the Linear or ``WeightNormLinear``, its BatchNorm or None)."""
    if isinstance(layer, nn.Sequential):
        return layer[0], layer[1]
    return layer, None


class _MLP(nn.Module):
    """Shared layer stack: ``layers``, the per-layer forward and folding."""

    def _build(self, widths: List[Tuple[int, int]], batch_norm: bool,
               weight_norm: bool, xavier: bool, bias_init: float,
               generator: Optional[torch.Generator],
               compute_dtype: Optional[torch.dtype]) -> None:
        self.compute_dtype = compute_dtype
        layers = []
        for i, (fan_in, fan_out) in enumerate(widths):
            if weight_norm:      # and no BatchNorm, as the JAX nets build it
                layers.append(WeightNormLinear(fan_in, fan_out, generator))
                continue
            lin = _linear(fan_in, fan_out, xavier, bias_init, generator)
            if batch_norm and i < len(widths) - 1:
                layers.append(nn.Sequential(
                    lin, nn.BatchNorm1d(fan_out, eps=BN_EPS)))
            else:
                layers.append(lin)
        self.layers = nn.ModuleList(layers)

    def _layer(self, i: int, x: torch.Tensor, train: bool,
               stats: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]]
               ) -> torch.Tensor:
        """Layer ``i`` (Linear, then BatchNorm). In train mode the batch's
        (mean, biased variance) go into ``stats`` when it is a dict."""
        dense, bn = dense_and_norm(self.layers[i])
        dtype = self.compute_dtype
        if dtype is None or isinstance(dense, WeightNormLinear):
            x = F.linear(x, dense.weight, dense.bias)
        else:
            x = x.to(dtype) @ dense.weight.to(dtype).t() + \
                dense.bias.to(dtype)
        if bn is None:
            return x
        out_dtype = x.dtype
        x = x.to(torch.promote_types(out_dtype, torch.float32))
        if not train:
            return F.batch_norm(x, bn.running_mean, bn.running_var,
                                bn.weight, bn.bias, False, 0.0,
                                bn.eps).to(out_dtype)
        var, mean = batch_var_mean(x)
        if stats is not None:
            stats[i] = (mean.detach(), var.detach())
        return ((x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) +
                bn.bias).to(out_dtype)

    def _updates(self, stats) -> Updates:
        """The new running statistics from each layer's batch (mean,
        biased variance), under the state-dict names."""
        if not stats:
            return {}
        layers = sorted(stats)
        olds, news = [], []
        for i in layers:
            bn = self.layers[i][1]
            olds += [bn.running_mean, bn.running_var]
            news += list(stats[i])
        blended = torch._foreach_add(
            torch._foreach_mul(olds, BN_MOMENTUM),
            torch._foreach_mul(news, 1.0 - BN_MOMENTUM))
        names = [f"layers.{i}.1.running_{s}" for i in layers
                 for s in ("mean", "var")]
        return dict(zip(names, blended))

    @torch.no_grad()
    def apply_updates(self, updates: Updates) -> None:
        """Keep a pass's running statistics (and count the batch in
        ``num_batches_tracked``, as ``nn.BatchNorm1d`` does)."""
        buffers = dict(self.named_buffers())
        for name, value in updates.items():
            buffers[name].copy_(value)
        for name in {n.rsplit(".", 1)[0] for n in updates}:
            buffers[f"{name}.num_batches_tracked"] += 1

    def folded_weights(self, detach: bool = True) -> Weights:
        """[(kernel (in, out), bias)] with eval-mode BatchNorm folded in, and
        weight norm's ``g·v/‖v‖`` taken. ``detach=False`` keeps the fold on
        the autograd graph, so that the kernels' weight gradients reach the
        Linear (or ``g`` and ``v``) and the BatchNorm scale and bias
        (training with frozen BatchNorm). Detached, no tensor takes a
        gradient (the last layer's bias is otherwise the Parameter itself),
        so the fused MLP launches without saving."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not detach):
            pairs = [fold_dense_bn(*dense_and_norm(layer))
                     for layer in self.layers]
        return [(w.detach(), b.detach()) for w, b in pairs] if detach \
            else pairs


class VectorFieldMLP(_MLP):
    """The neural vector field v: R^3 → S^2 (+ feature vector)."""

    def __init__(self, config: VFNetConfig,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.config = config
        in_dim = embedding_dim(config.embedder_multires, config.input_dims)
        dims = [in_dim] + list(config.dimensions) + \
            [config.output_dims + config.feature_vector_dims]
        self.skips = list(config.skip_connection_in or [])
        widths, width = [], in_dim
        for i in range(len(dims) - 1):
            if i in self.skips:
                width += in_dim
            out_dim = dims[i + 1] - in_dim if (i + 1) in self.skips \
                else dims[i + 1]
            widths.append((width, out_dim))
            width = out_dim
        self._build(widths, config.batch_norm, config.weight_norm,
                    config.xavier_init, config.bias_init, generator,
                    compute_dtype)

    @property
    def skip_at(self) -> Optional[int]:
        """The one skip layer the fused kernel takes (None without one)."""
        if len(self.skips) > 1:
            raise NotImplementedError("more than one skip layer")
        return self.skips[0] if self.skips else None

    def forward(self, points: torch.Tensor, train: bool = False,
                keep_stats: bool = True) -> Tuple[torch.Tensor, Updates]:
        """points (N, 3) → ((N, output_dims + feature_dims), updates): the
        new running statistics in train mode (with ``keep_stats``), else
        {}."""
        cfg = self.config
        if train and cfg.dropout and cfg.dropout_probability > 0.0:
            raise NotImplementedError(
                "dropout in train mode is not ported: the JAX renderer "
                "passes no 'dropout' rng, so the JAX package cannot train "
                "with it either")
        stats = {} if train and keep_stats else None
        x = positional_encoding(points, cfg.embedder_multires)
        embedded = x
        n = len(self.layers)
        for i in range(n):
            if i in self.skips:
                x = torch.cat([x, embedded], dim=1) / 2.0 ** 0.5
            x = self._layer(i, x, train, stats)
            x = torch.relu(x) if i < n - 1 else torch.tanh(x)
        return x.to(points.dtype), self._updates(stats)


def vf_jacobian(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                points: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) Jacobian ``jac[n, i, j] = d v_i / d p_j`` of the field (the
    first three outputs of ``apply_fn``) by three forward-mode JVPs
    (``torch.func.jvp``), each tangent the basis vector ``e_j`` broadcast to
    every point, as the JAX package takes it. ``apply_fn`` must be
    functional (it writes no buffer); the result stays on the autograd
    graph of the tensors ``apply_fn`` closes over."""
    def field(p):
        return apply_fn(p)[:, :3]

    cols = []
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    for j in range(3):
        tangent = eye[j].expand(points.shape).contiguous()
        _, dv = torch.func.jvp(field, (points,), (tangent,))
        cols.append(dv)
    return torch.stack(cols, dim=-1)


def numerical_vf_jacobian(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                          points: torch.Tensor,
                          epsilon: float = 1e-5) -> torch.Tensor:
    """Central-difference Jacobian, ``(v(p + ε e_j) − v(p − ε e_j)) / 2ε``
    per column (reference ``compute_numerical_directional_derivatives``,
    ``models/nerf/vector_field_nerf.py:500-526``): six passes of
    ``apply_fn``."""
    cols = []
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    for j in range(3):
        offset = eye[j] * epsilon
        pos = apply_fn(points + offset)[:, :3]
        neg = apply_fn(points - offset)[:, :3]
        cols.append((pos - neg) / (2.0 * epsilon))
    return torch.stack(cols, dim=-1)


def directional_derivatives(normals: torch.Tensor,
                            jac: torch.Tensor) -> torch.Tensor:
    """The field's derivatives along two tangents of each normal (reference
    ``compute_directional_derivatives``,
    ``models/nerf/vector_field_nerf.py:476-498``): ``t1 = (n_y, −n_x, 0)``,
    ``t2 = n × t1``, each normalized (floor 1e-8); returns (N, 2, 3) =
    jac · t."""
    t1 = torch.stack([normals[:, 1], -normals[:, 0],
                      torch.zeros_like(normals[:, 0])], dim=1)
    t2 = torch.linalg.cross(normals, t1, dim=1)

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=1,
                                                        keepdim=True),
                               min=1e-8)

    d1 = torch.einsum("nij,nj->ni", jac, unit(t1))
    d2 = torch.einsum("nij,nj->ni", jac, unit(t2))
    return torch.stack([d1, d2], dim=1)


class RenderingMLP(_MLP):
    """IDR-style colour network."""

    def __init__(self, config: RenderingNetConfig,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.config = config
        dims = [self.input_dim(config)] + list(config.dimensions) + \
            [config.output_dims]
        self._build(list(zip(dims[:-1], dims[1:])), config.batch_norm,
                    config.weight_norm, False, 0.0, generator, compute_dtype)

    @staticmethod
    def input_dim(config: RenderingNetConfig) -> int:
        view = embedding_dim(config.embedder_multires)
        dim = 3
        if config.mode in ("idr", "no_normals"):
            dim += view
        if config.mode in ("idr", "no_view_dir"):
            dim += 3
        return dim + config.feature_vector_dims

    def inputs(self, points, normals, view_dirs,
               feature_vectors: Optional[torch.Tensor]) -> torch.Tensor:
        """The concatenated input ``[xyz, PE(view), normals, features]``;
        with ``detach_normals`` the normals take no gradient from the
        colour (reference ``rendering_network.py:76-77``)."""
        cfg = self.config
        if cfg.detach_normals:
            normals = normals.detach()
        if cfg.embedder_multires > 0:
            view_dirs = positional_encoding(view_dirs, cfg.embedder_multires)
        parts = [points]
        if cfg.mode in ("idr", "no_normals"):
            parts.append(view_dirs)
        if cfg.mode in ("idr", "no_view_dir"):
            parts.append(normals)
        if feature_vectors is not None and feature_vectors.numel() > 0 \
                and cfg.feature_vector_dims > 0:
            parts.append(feature_vectors)
        return torch.cat(parts, dim=-1)

    def forward(self, points, normals, view_dirs,
                feature_vectors: Optional[torch.Tensor],
                train: bool = False, keep_stats: bool = True
                ) -> Tuple[torch.Tensor, Updates]:
        """(sigmoid colours (N, 3), updates), as ``VectorFieldMLP``."""
        stats = {} if train and keep_stats else None
        x = self.inputs(points, normals, view_dirs, feature_vectors)
        n = len(self.layers)
        for i in range(n):
            x = self._layer(i, x, train, stats)
            if i < n - 1:
                x = torch.relu(x)
        return torch.sigmoid(x).to(points.dtype), self._updates(stats)
