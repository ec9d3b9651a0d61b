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
it has BatchNorm (every layer but the last), else a plain ``nn.Linear`` —
exactly the reference state-dict layout (``layers.{i}.0.weight``,
``layers.{i}.1.running_mean``, ``layers.{i}.weight``), so reference ``.pth``
files load as they are. Init is torch's default Linear init, U(±1/√fan_in),
or Xavier with a constant bias when ``xavier_init``.

BatchNorm runs on its running statistics (eval render, and training with
BatchNorm frozen as the shipped conf trains); weight norm, dropout in
training and train-mode BatchNorm raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from vf_nerf_torch.config.schema import RenderingNetConfig, VFNetConfig
from vf_nerf_torch.ops.embedding import embedding_dim, positional_encoding
from vf_nerf_torch.ops.fused_mlp import Weights, fold_dense_bn


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


class _MLP(nn.Module):
    """Shared layer stack: ``layers`` plus eval-mode forward and folding."""

    def _build(self, widths: List[Tuple[int, int]], batch_norm: bool,
               xavier: bool, bias_init: float,
               generator: Optional[torch.Generator]) -> None:
        layers = []
        for i, (fan_in, fan_out) in enumerate(widths):
            lin = _linear(fan_in, fan_out, xavier, bias_init, generator)
            if batch_norm and i < len(widths) - 1:
                layers.append(nn.Sequential(lin, nn.BatchNorm1d(fan_out)))
            else:
                layers.append(lin)
        self.layers = nn.ModuleList(layers)

    def _layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval()")
        return self.layers[i](x)

    def folded_weights(self, detach: bool = True) -> Weights:
        """[(kernel (in, out), bias)] with eval-mode BatchNorm folded in.
        ``detach=False`` keeps the fold on the autograd graph, so that the
        kernels' weight gradients reach the Linear weights and the
        BatchNorm scale and bias (training with frozen BatchNorm). Detached,
        no tensor takes a gradient (the last layer's bias is otherwise the
        Parameter itself), so the fused MLP launches without saving."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not detach):
            pairs = [fold_dense_bn(*layer) if isinstance(layer, nn.Sequential)
                     else fold_dense_bn(layer) for layer in self.layers]
        return [(w.detach(), b.detach()) for w, b in pairs] if detach \
            else pairs


class VectorFieldMLP(_MLP):
    """The neural vector field v: R^3 → S^2 (+ feature vector)."""

    def __init__(self, config: VFNetConfig,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if config.weight_norm:
            raise NotImplementedError("weight_norm is not ported yet")
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
        self._build(widths, config.batch_norm, config.xavier_init,
                    config.bias_init, generator)

    @property
    def skip_at(self) -> Optional[int]:
        """The one skip layer the fused kernel takes (None without one)."""
        if len(self.skips) > 1:
            raise NotImplementedError("more than one skip layer")
        return self.skips[0] if self.skips else None

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """points (N, 3) → (N, output_dims + feature_dims), eval-mode BN."""
        x = positional_encoding(points, self.config.embedder_multires)
        embedded = x
        n = len(self.layers)
        for i in range(n):
            if i in self.skips:
                x = torch.cat([x, embedded], dim=1) / 2.0 ** 0.5
            x = self._layer(i, x)
            x = torch.relu(x) if i < n - 1 else torch.tanh(x)
        return x


class RenderingMLP(_MLP):
    """IDR-style colour network."""

    def __init__(self, config: RenderingNetConfig,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if config.weight_norm:
            raise NotImplementedError("weight_norm is not ported yet")
        self.config = config
        dims = [self.input_dim(config)] + list(config.dimensions) + \
            [config.output_dims]
        self._build(list(zip(dims[:-1], dims[1:])), config.batch_norm,
                    False, 0.0, generator)

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
                feature_vectors: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.inputs(points, normals, view_dirs, feature_vectors)
        n = len(self.layers)
        for i in range(n):
            x = self._layer(i, x)
            if i < n - 1:
                x = torch.relu(x)
        return torch.sigmoid(x)
