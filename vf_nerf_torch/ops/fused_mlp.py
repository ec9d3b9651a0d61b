"""Fused MLP: BatchNorm folding, the plain forward and backward, and the
wrapper of the CUDA kernel ``csrc/fused_mlp.cu`` (port of
``vf_nerf_tpu/ops/fused_mlp.py``).

In eval mode BatchNorm is a fixed affine map that folds into the preceding
Linear (``fold_dense_bn``), so the render path runs plain dense layers:
``h = relu(h @ W + b)``, the skip layer taking ``concat([h, x]) / sqrt(2)``,
the last layer without ReLU and ending in tanh or sigmoid. Weights keep the
JAX package's (in, out) layout at this module's functions.

Training (frozen BatchNorm, as the shipped conf trains) runs the same
kernel in its activation-save mode and ``FusedMLP``'s backward
(``mlp_backward_reference``) on cuBLAS; autograd carries the weight
gradients through ``fold_dense_bn`` to the Linear and BatchNorm
parameters. The saved activations are one layer-major tensor of
``acts_shape``; ``hidden_views`` cuts it into the per-layer outputs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from vf_nerf_torch.kernels import count_launch, load_library

Weights = List[Tuple[torch.Tensor, torch.Tensor]]
_ACTS = {"none": 0, "tanh": 1, "sigmoid": 2}
# Row pitch (floats) of the saved activations: the kernel's shared
# activation tile's (``vfn_fused_mlp_acts_pitch``), so that one block's rows
# of a layer are one bulk copy.
ACTS_PITCH = 300
# The kernel's blocks take 128 points, or 64 with the outputs split between
# its two warpgroups; this is the time of a 64-point block over a 128-point
# block's, with which ``blocks_of_128`` weighs rounds of blocks (on the
# H100, ``split_block_cost`` in chip_smoke.py phase train_kernels).
SPLIT_BLOCK_COST = 0.62


def acts_shape(weights: Weights, n_points: int) -> Tuple[int, int, int]:
    """Shape of the saved activations of ``n_points`` points: (hidden
    layers, points, ``ACTS_PITCH``), layer-major. Hidden layer l's output is
    the first ``width_l`` columns of ``acts[l]``; the columns after it hold
    whatever the kernel's tile held there and are never read."""
    return len(weights) - 1, n_points, ACTS_PITCH


def hidden_views(acts: torch.Tensor, weights: Weights) -> List[torch.Tensor]:
    """Each hidden layer's (N, width) output: views (row stride
    ``ACTS_PITCH``) of the saved activations ``acts`` of ``acts_shape``."""
    if acts.shape != acts_shape(weights, acts.shape[1]):
        raise ValueError(f"saved activations of shape {tuple(acts.shape)}; "
                         f"these layers save "
                         f"{acts_shape(weights, acts.shape[1])}")
    return [acts[i, :, :w.shape[1]] for i, (w, _) in enumerate(weights[:-1])]


def blocks_of_128(n_points: int, n_sms: int) -> int:
    """How many 128-point blocks lead the launch of ``n_points`` on a card
    of ``n_sms`` SMs (one block per SM at a time); the points after them go
    in 64-point split blocks, which start last. Of all 128-point blocks,
    or k full rounds of them and the rest split, the fewest estimated
    rounds: the training step's 20,480 shell points take one round of 132
    blocks and 56 split blocks (1.6 rounds, not 2), its 204,800 fine points
    12 rounds and 32 split blocks; the render's 133,120 points stay all
    128 (their rest would take two rounds of split blocks)."""
    def rounds(blocks):
        return -(-blocks // n_sms)

    full = -(-n_points // 128)
    best, cost = full, rounds(full)
    for k in range(full // n_sms + 1):
        rest = max(0, n_points - 128 * k * n_sms)
        c = k + SPLIT_BLOCK_COST * rounds(-(-rest // 64))
        if c < cost:
            best, cost = k * n_sms, c
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _limits(lib) -> Tuple[int, int]:
    """The kernel's widest layer input and hidden layer, read once per
    library, after checking its saved-activation pitch against
    ``ACTS_PITCH``."""
    if lib.lib.vfn_fused_mlp_acts_pitch() != ACTS_PITCH:
        raise RuntimeError("the kernel's saved-activation pitch differs "
                           "from ACTS_PITCH")
    return (lib.lib.vfn_fused_mlp_max_width(),
            lib.lib.vfn_fused_mlp_max_hidden())


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


def mlp_backward_reference(weights: Weights, x: torch.Tensor,
                           acts: torch.Tensor, y: torch.Tensor,
                           dy: torch.Tensor, skip_at: Optional[int],
                           final_act: str, need_dx: bool = True,
                           need_weights: bool = True):
    """The backward of ``mlp_reference`` from the forward's saved values.

    :param acts: every hidden layer's post-ReLU output, of ``acts_shape``
        (what the kernel's save mode writes), read through ``hidden_views``.
    :param y: (N, out) the forward's output; ``dy`` its gradient.
    :param need_weights: compute dW and db (off, their entries are None:
        the joint stage's pose-only epochs ask for dx alone).
    :return: ([(dW (in, out), db (out,)) or (None, None)] per layer,
        dx (N, in) or None).

    The chain: the final activation's derivative (tanh' = 1 − y²,
    sigmoid' = y(1 − y)), then per layer from the last,
    ``dW_i = H_{i−1}ᵀ dZ_i``, ``db_i = Σ dZ_i``, ``dH_{i−1} = dZ_i W_iᵀ``
    and ``dZ_{i−1} = dH_{i−1} · [H_{i−1} > 0]``; the skip layer's input is
    ``concat([h, x]) / √2``, so its incoming gradient splits ÷ √2 into h and
    x. The products are ``torch.matmul``: cuBLAS on the card, in f32 while
    ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
    default, which the port's scripts set).
    """
    n = len(weights)
    hidden = hidden_views(acts, weights)
    if final_act == "tanh":
        dz = dy * (1.0 - y * y)
    elif final_act == "sigmoid":
        dz = dy * (y * (1.0 - y))
    else:
        dz = dy
    rsqrt2 = 1.0 / math.sqrt(2.0)
    grads = [(None, None)] * n
    dx = None
    for i in range(n - 1, -1, -1):
        w = weights[i][0]
        h = x if i == 0 else hidden[i - 1]
        if need_weights:
            inp = torch.cat([h, x], dim=1) / math.sqrt(2.0) \
                if skip_at is not None and i == skip_at else h
            grads[i] = (inp.t() @ dz, dz.sum(0))
        if i == 0 and not need_dx:
            break
        dh = dz @ w.t()
        if skip_at is not None and i == skip_at:
            dx_skip = dh[:, h.shape[1]:] * rsqrt2
            dx = dx_skip if dx is None else dx + dx_skip
            dh = dh[:, :h.shape[1]] * rsqrt2
        if i == 0:
            dx = dh if dx is None else dx + dh
        else:
            dz = dh * (hidden[i - 1] > 0)
    return grads, dx


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

    A CPU tensor takes the plain version (under autograd when a gradient is
    asked for); a CUDA tensor launches the kernel or raises. The kernel
    computes in 3xTF32 on the tensor cores (of f32 grade) and takes layer
    inputs up to ``vfn_fused_mlp_max_width()`` (296) and hidden layers up
    to ``vfn_fused_mlp_max_hidden()`` (256) wide. When grad mode is on and
    x or a weight takes a gradient, the call goes through ``FusedMLP``: the
    kernel also saves the hidden activations, and the backward runs
    ``mlp_backward_reference`` on cuBLAS.
    """
    if final_act not in _ACTS:
        raise ValueError(f"final_act must be one of {sorted(_ACTS)}")
    _check_layers(weights, x.shape[1], skip_at)
    if x.device.type == "cpu":
        return mlp_reference(weights, x, skip_at, final_act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp takes CPU or CUDA tensors, not "
                         f"{x.device}")
    flat = [t for wb in weights for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in [x] + flat):
        return FusedMLP.apply(x, skip_at, final_act, *flat)
    out, _ = _launch(weights, x, skip_at, final_act, save=False)
    return out


fused_mlp.launches = 0


class FusedMLP(torch.autograd.Function):
    """``fused_mlp`` with a gradient, on CUDA tensors: the forward kernel in
    its activation-save mode, and ``mlp_backward_reference`` as the
    backward (its products on cuBLAS in f32 with TF32 off). Inputs: x, the
    skip layer, the final activation, then each layer's kernel and bias."""

    @staticmethod
    def forward(ctx, x, skip_at, final_act, *flat):
        weights = list(zip(flat[0::2], flat[1::2]))
        y, acts = _launch(weights, x, skip_at, final_act, save=True)
        ctx.skip_at, ctx.final_act = skip_at, final_act
        ctx.save_for_backward(x, acts, y, *flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, acts, y, *flat = ctx.saved_tensors
        weights = list(zip(flat[0::2], flat[1::2]))
        need_dx = ctx.needs_input_grad[0]
        grads, dx = mlp_backward_reference(
            weights, x, acts, y, dy, ctx.skip_at, ctx.final_act,
            need_dx=need_dx, need_weights=any(ctx.needs_input_grad[3:]))
        return (dx if need_dx else None, None, None) + \
            tuple(t for g in grads for t in g)


def _launch(weights: Weights, x: torch.Tensor, skip_at: Optional[int],
            final_act: str, save: bool, blocks128: Optional[int] = None):
    """One kernel launch on CUDA tensors: (out (N, out_dim), acts of
    ``acts_shape`` when ``save``, else None). ``blocks128``: the leading
    128-point blocks (0 .. ceil(N / 128); the rest of the points in 64-point
    split blocks); None lets ``blocks_of_128`` choose."""
    tensors = [x] + [t for wb in weights for t in wb]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("fused_mlp needs contiguous float32 tensors on "
                             f"one device; got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")
    lib = load_library()
    max_width, max_hidden = _limits(lib)
    widest = max([x.shape[1]] + [w.shape[0] for w, _ in weights])
    hidden = max([0] + [w.shape[1] for w, _ in weights[:-1]])
    if widest > max_width or hidden > max_hidden:
        raise ValueError(f"fused_mlp supports widths up to {max_width} "
                         f"(layer inputs) and {max_hidden} (hidden layers); "
                         f"got {widest} and {hidden}")
    n_layers = len(weights)
    n_points = x.shape[0]
    out = torch.empty((n_points, weights[-1][0].shape[1]),
                      dtype=torch.float32, device=x.device)
    acts = torch.empty(acts_shape(weights, n_points), dtype=torch.float32,
                       device=x.device) if save else None
    if n_points == 0:
        return out, acts
    if blocks128 is None:
        blocks128 = blocks_of_128(n_points, _sm_count(x.device.index))
    ptrs = _pointer_arrays(weights)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lib.vfn_fused_mlp(
            x.data_ptr(), out.data_ptr(), n_points, x.shape[1], *ptrs,
            n_layers, -1 if skip_at is None else skip_at, _ACTS[final_act],
            None if acts is None else acts.data_ptr(), blocks128, stream)
    lib.check(code, "fused_mlp launch")
    count_launch(fused_mlp)
    return out, acts


def _pointer_arrays(weights: Weights):
    """Host arrays of the layers' device pointers and widths."""
    n = len(weights)
    w_ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in weights])
    b_ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in weights])
    k_dims = (ctypes.c_int * n)(*[w.shape[0] for w, _ in weights])
    n_dims = (ctypes.c_int * n)(*[w.shape[1] for w, _ in weights])
    return w_ptrs, b_ptrs, k_dims, n_dims
