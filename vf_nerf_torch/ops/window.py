"""Windowed cosine similarity over consecutive ray samples (port of
``vf_nerf_tpu/ops/window.py``; reference
``models/helpers/functions.py:41-72``).

Quirks kept: with W taps, ``start = (W + 1) // 2 + 1`` and
``middle = (W - 1) // 2``; only positions ``[start, L - start)`` of the
length-L cosine array are windowed and the edges keep the raw consecutive
cosine; the centre tap is signed while the neighbour taps use ``|w|``; the
normalizer is ``sum(|w|)``. Forward taps pair ``(n_j, n_{j+1+i})`` and
backward taps ``(n_j, n_{j-i})`` for ``i = 1 .. start-2``.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-8  # torch F.cosine_similarity eps


def cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                      dim: int = -1) -> torch.Tensor:
    """``dot / (max(||x||, eps) * max(||y||, eps))``."""
    dot = torch.sum(x * y, dim=dim)
    nx = torch.clamp(torch.linalg.vector_norm(x, dim=dim), min=_EPS)
    ny = torch.clamp(torch.linalg.vector_norm(y, dim=dim), min=_EPS)
    return dot / (nx * ny)


def window_cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                             weights: torch.Tensor,
                             n_valid: Optional[int] = None) -> torch.Tensor:
    """(R, L) windowed cosines of ``x = normals[:, :-1]`` against
    ``y = normals[:, 1:]`` with (W,) tap ``weights``.

    ``n_valid``: the number of live samples when the ray's tail is padding
    (static fine growth). Positions from ``n_valid - 1 - start`` on keep the
    raw cosine, as in an unpadded array of ``n_valid`` samples, so no live
    window reads a pad sample.
    """
    n_taps = weights.shape[0]
    start = (n_taps + 1) // 2 + 1
    middle = (n_taps - 1) // 2
    length = x.shape[1]

    normalizer = torch.sum(torch.abs(weights))
    cs = cosine_similarity(x, y)
    hi = length - start
    if hi <= start:
        return cs

    x_mid = x[:, start:hi]
    acc = cs[:, start:hi] * weights[middle] / normalizer
    for i in range(1, start - 1):
        fwd = cosine_similarity(x_mid, y[:, start + i:hi + i])
        bwd = cosine_similarity(x_mid, y[:, start - i - 1:hi - i - 1])
        acc = acc + fwd * torch.abs(weights[middle + i]) / normalizer \
                  + bwd * torch.abs(weights[middle - i]) / normalizer
    out = cs.clone()
    out[:, start:hi] = acc
    if n_valid is not None:
        live = torch.arange(length, device=cs.device) < n_valid - 1 - start
        out = torch.where(live[None, :], out, cs)
    return out
