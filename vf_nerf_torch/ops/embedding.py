"""NeRF positional encoding (port of ``vf_nerf_tpu/ops/embedding.py``;
reference ``models/helpers/embedder.py:6-52``).

Output layout is ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]``:
the identity first, then a (sin, cos) pair of whole 3-wide blocks per
frequency. Every transplanted weight depends on this order.
"""

from __future__ import annotations

import torch


def embedding_dim(multires: int, input_dims: int = 3) -> int:
    """Output channel count: identity + 2 * multires frequency blocks."""
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Embed (..., d) to (..., d * (1 + 2 * multires))."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]               # (..., F, d)
    trig = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    return torch.cat([x, trig.flatten(-3)], dim=-1)
