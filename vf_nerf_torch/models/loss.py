"""The VF-NeRF training loss (port of ``vf_nerf_tpu/models/loss.py:33-131``;
reference ``models/losses/vf_loss.py:13-87``). Terms, with the weights of
``confs/vf_nerf.conf``:

- RGB L1;
- depth L1, clamped elementwise at ``depth_loss_clamp`` before the mean;
- unit norm ``mean((||v|| - 1)^2)`` over the rendered normals;
- MSE of the field against its supervision targets, pooled over the
  (prediction, target, mask) triples;
- the ``relu(||v|| - 1)^2`` hinge from epoch ``norm_smaller_than_one_start``;
- the mean directional-derivative norm from
  ``directional_derivatives_start`` (when the predictions carry them).

With static fine growth the per-sample means run over the live samples
(``sample_mask``), which equals the unpadded means. ``similarity_loss``
(``vf_nerf_tpu/models/loss.py:165``) is the joint stage's.

Data parallel (``parallel/mesh.py``): every mean, masked count and gate is
over the global batch, as GSPMD reduces them in the JAX package. Each rank
returns its numerator over the global count (counts summed over the ranks,
detached; the clamp to 1 applies to the global count), so the sum of the
ranks' losses is the one-process loss. At one rank the arithmetic is the
one-process arithmetic.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from vf_nerf_torch.config.schema import VFLossConfig, VFLossWeights
from vf_nerf_torch.ops.rays import normalize
from vf_nerf_torch.parallel.mesh import global_max, global_mean, global_sum

Term = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def masked_sq_err(pred: torch.Tensor, gt: torch.Tensor,
                  mask: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squared errors over the masked rows, number of masked
    elements), both of this rank's rows. Unmasked, the count is a 0-d
    host tensor, which torch's ops on any device take as a scalar: a
    device tensor made from a host number is a blocking copy."""
    sq = (pred - gt) ** 2
    if mask is None:
        return torch.sum(sq), torch.tensor(float(sq.numel()), dtype=sq.dtype)
    m = mask.to(sq.dtype)
    return torch.sum(sq * m[..., None]), torch.sum(m) * sq.shape[-1]


def vf_loss(predictions: Dict[str, torch.Tensor],
            ground_truth: Dict[str, torch.Tensor],
            supervision_terms: Sequence[Term],
            weights: VFLossWeights, config: VFLossConfig,
            epoch: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted total and each term.

    :param predictions: ``rgb`` (R, 3), ``depth`` (R, 1), ``normals`` (N, 3)
        all rendered field samples, optional ``sample_mask`` (N,) and
        ``dir_derivative_norms`` (M,).
    :param ground_truth: ``rgb`` (R, 3), ``depth`` (R, 1) (None or size 0 to
        skip).
    :param supervision_terms: (pred normals, target normals, mask or None)
        triples pooled into one MSE (trainer ``:180-216``).
    :param epoch: the epoch, for the gates.
    """
    rgb_loss = global_mean(torch.abs(predictions["rgb"] -
                                     ground_truth["rgb"]))
    zero = rgb_loss.new_zeros(())

    gt_depth = ground_truth.get("depth")
    if gt_depth is not None and gt_depth.numel() > 0:
        per_elem = torch.clamp(torch.abs(predictions["depth"] - gt_depth),
                               max=config.depth_loss_clamp)
        if config.mask_invalid_depth:
            valid = (gt_depth > 0).to(per_elem.dtype)
            depth_loss = torch.sum(per_elem * valid) / torch.clamp(
                global_sum(torch.sum(valid)), min=1.0)
        else:
            depth_loss = global_mean(per_elem)
    else:
        depth_loss = zero

    norms = torch.linalg.vector_norm(predictions["normals"], dim=1)
    sample_mask = predictions.get("sample_mask")

    def sample_mean(values: torch.Tensor) -> torch.Tensor:
        if sample_mask is None:
            return global_mean(values)
        return torch.sum(values * sample_mask) / torch.clamp(
            global_sum(torch.sum(sample_mask)), min=1.0)

    unit_norm_loss = sample_mean((norms - 1.0) ** 2)

    sup_sum, sup_count = zero, zero
    for pred_n, gt_n, mask in supervision_terms:
        s, c = masked_sq_err(pred_n, gt_n, mask)
        sup_sum = sup_sum + s
        sup_count = sup_count + c
    sup_count = global_sum(sup_count)
    supervision_loss = torch.where(
        sup_count > 0, sup_sum / torch.clamp(sup_count, min=1.0), zero)

    norm_hinge_loss = sample_mean(torch.relu(norms - 1.0) ** 2) \
        if epoch >= config.norm_smaller_than_one_start else zero

    dd = predictions.get("dir_derivative_norms")
    dir_deriv_loss = sample_mean(dd) \
        if dd is not None and epoch >= config.directional_derivatives_start \
        else zero

    total = (weights.rgb * rgb_loss +
             weights.depth * depth_loss +
             weights.unit_norm * unit_norm_loss +
             weights.supervision * supervision_loss +
             weights.norm_smaller_than_one * norm_hinge_loss +
             weights.directional_derivatives * dir_deriv_loss)
    return total, {
        "rgb_loss": rgb_loss,
        "depth_loss": depth_loss,
        "unit_norm_loss": unit_norm_loss,
        "supervision_loss": supervision_loss,
        "norm_smaller_than_one_loss": norm_hinge_loss,
        "directional_derivatives_loss": dir_deriv_loss,
    }


def similarity_loss(x1: torch.Tensor, x2: torch.Tensor, v1: torch.Tensor,
                    v2: torch.Tensor) -> torch.Tensor:
    """Point-pair field consistency (port of
    ``vf_nerf_tpu/models/loss.py:165``; reference ``get_similarity_loss``,
    ``models/helpers/functions.py:183-225``), used by the joint stage: each
    point should reach its partner by walking its unit field vector for the
    pair's distance. Pairs whose fields oppose (cosine < 0.5, without a
    gradient) and whose miss exceeds half the largest miss (also without a
    gradient) count, weighted by 1 − cosine; 0 when no pair does. Data
    parallel, the largest miss and the count are the global batch's."""
    distance = torch.linalg.vector_norm(x2 - x1, dim=1, keepdim=True)
    x1_est = x2 + normalize(v2, dim=1) * distance
    x2_est = x1 + normalize(v1, dim=1) * distance
    diff = torch.linalg.vector_norm(x1 - x1_est, dim=1) + \
        torch.linalg.vector_norm(x2 - x2_est, dim=1)
    cos = torch.sum(normalize(v1, dim=1) * normalize(v2, dim=1),
                    dim=1).detach()
    gate = (cos < 0.5) & (diff > 0.5 * global_max(diff.detach().max()))
    count = global_sum(torch.sum(gate))
    weighted = torch.sum(torch.where(gate, diff * (1.0 - cos),
                                     torch.zeros_like(diff)))
    return torch.where(count > 0, weighted / torch.clamp(count, min=1),
                       torch.zeros_like(weighted))
