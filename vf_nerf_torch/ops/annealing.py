"""Window-weight annealing (port of ``vf_nerf_tpu/ops/annealing.py``;
reference ``utils/weight_annealing.py:32-74``). Runs on the host once per
epoch, so it is plain numpy; the result goes to the renderer as a (W,)
tensor."""

from __future__ import annotations

import numpy as np


def linear_annealing_weights(n_weights: int, n_epochs: int, epoch: int,
                             soft: bool = False) -> np.ndarray:
    """Triangular window that sharpens toward the centre tap:
    ``relu(mid - mid/n_epochs * epoch * |idx|)`` normalized; "soft" floors
    the 4 nearest neighbours at 0.05 once the centre reaches 0.8. Negative
    epochs return the uniform window."""
    if epoch < 0:
        return np.full(n_weights, 1.0 / n_weights, dtype=np.float32)
    mid = (n_weights - 1) / 2.0
    idx = np.abs(np.arange(n_weights, dtype=np.float32) - int(mid))
    relu = np.maximum(-mid / n_epochs * epoch * idx + mid, 0.0)
    weights = (relu / relu.sum()).astype(np.float32)
    centre = int(mid)
    if soft and weights[centre] >= 0.8:
        weights[centre - 2:centre + 3] = 0.05
        weights[centre] = 0.8
    return weights


def annealed_window_weights(base_weights: np.ndarray, anneal_mode: str,
                            anneal_start: int, anneal_end: int, epoch: int,
                            soft: bool = False) -> np.ndarray:
    """Epoch-gated window weights (reference
    ``models/nerf/vector_field_nerf.py:232-234``): the base weights until
    ``anneal_start`` or with mode "none", then the linear schedule over
    ``anneal_end - anneal_start`` epochs."""
    if anneal_mode == "none" or epoch <= anneal_start:
        return np.asarray(base_weights, dtype=np.float32)
    return linear_annealing_weights(len(base_weights),
                                    anneal_end - anneal_start,
                                    epoch - anneal_start,
                                    soft=(anneal_mode == "soft"))
