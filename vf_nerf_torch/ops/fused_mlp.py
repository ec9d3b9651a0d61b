"""Fused MLP forward: BatchNorm folding, the plain version, and the wrapper
of the CUDA kernel ``csrc/fused_mlp.cu`` (port of
``vf_nerf_tpu/ops/fused_mlp.py``).

In eval mode BatchNorm is a fixed affine map that folds into the preceding
Linear (``fold_dense_bn``), so the render path runs plain dense layers:
``h = relu(h @ W + b)``, the skip layer taking ``concat([h, x]) / sqrt(2)``,
the last layer without ReLU and ending in tanh or sigmoid. Weights keep the
JAX package's (in, out) layout at this module's functions.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from vf_nerf_torch.kernels import load_library

Weights = List[Tuple[torch.Tensor, torch.Tensor]]
_ACTS = {"none": 0, "tanh": 1, "sigmoid": 2}


def fold_dense_bn(linear: nn.Linear, bn: Optional[nn.BatchNorm1d] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Linear (+ eval-mode BatchNorm) → (kernel (in, out), bias (out,))
    with ``W' = W·diag(s)``, ``b' = (b − μ)·s + β``, ``s = γ/√(σ² + ε)``
    (ε is the BatchNorm's, 1e-5 by default)."""
    kernel = linear.weight.t()
    bias = linear.bias
    if bn is not None:
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        kernel = kernel * scale[None, :]
        bias = (bias - bn.running_mean) * scale + bn.bias
    return kernel.contiguous(), bias.contiguous()


def mlp_reference(weights: Weights, x: torch.Tensor, skip_at: Optional[int],
                  final_act: str) -> torch.Tensor:
    """The plain PyTorch forward over folded weights (the kernel's oracle)."""
    embedded = x
    h = x
    n = len(weights)
    for i, (w, b) in enumerate(weights):
        if skip_at is not None and i == skip_at:
            h = torch.cat([h, embedded], dim=1) / math.sqrt(2.0)
        h = h @ w + b
        if i < n - 1:
            h = torch.relu(h)
    if final_act == "tanh":
        return torch.tanh(h)
    if final_act == "sigmoid":
        return torch.sigmoid(h)
    return h


def _check_layers(weights: Weights, in_dim: int,
                  skip_at: Optional[int]) -> None:
    width = in_dim
    for i, (w, b) in enumerate(weights):
        if skip_at is not None and i == skip_at:
            width += in_dim
        if w.ndim != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: kernel {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not take width {width}")
        width = w.shape[1]


def fused_mlp(weights: Weights, x: torch.Tensor,
              skip_at: Optional[int] = None,
              final_act: str = "none") -> torch.Tensor:
    """All layers of the folded MLP in one kernel launch.

    :param weights: [(kernel (in, out), bias (out,))] per layer, f32.
    :param x: (N, in_dim) f32 inputs, already positional-encoded.
    :param skip_at: layer that takes ``concat([h, x]) / sqrt(2)``.
    :return: (N, out_dim).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if final_act not in _ACTS:
        raise ValueError(f"final_act must be one of {sorted(_ACTS)}")
    _check_layers(weights, x.shape[1], skip_at)
    if x.device.type == "cpu":
        return mlp_reference(weights, x, skip_at, final_act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp takes CPU or CUDA tensors, not "
                         f"{x.device}")
    tensors = [x] + [t for wb in weights for t in wb]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("fused_mlp needs contiguous float32 tensors on "
                             f"one device; got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")
    lib = load_library()
    widest = max([x.shape[1]] + [max(w.shape) for w, _ in weights])
    if widest > lib.lib.vfn_fused_mlp_max_width():
        raise ValueError(f"fused_mlp supports widths up to "
                         f"{lib.lib.vfn_fused_mlp_max_width()}, got {widest}")
    n_layers = len(weights)
    out = torch.empty((x.shape[0], weights[-1][0].shape[1]),
                      dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    ptrs = _pointer_arrays(weights)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lib.vfn_fused_mlp(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], *ptrs,
            n_layers, -1 if skip_at is None else skip_at, _ACTS[final_act],
            stream)
    lib.check(code, "fused_mlp launch")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def _pointer_arrays(weights: Weights):
    """Host arrays of the layers' device pointers and widths."""
    n = len(weights)
    w_ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in weights])
    b_ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in weights])
    k_dims = (ctypes.c_int * n)(*[w.shape[0] for w, _ in weights])
    n_dims = (ctypes.c_int * n)(*[w.shape[1] for w, _ in weights])
    return w_ptrs, b_ptrs, k_dims, n_dims
