"""Weights carried into the port's modules.

- ``load_jax_variables``: the JAX package's variables as a numpy pytree
  (``params.{vf,render}.layer_i.{Dense_0,BatchNorm_0}``,
  ``batch_stats.{vf,render}.layer_i.BatchNorm_0.{mean,var}`` and
  ``params.density`` with ``beta/scale/mean`` as a dict or a named tuple).
  Dense kernels transpose from (in, out) to torch's (out, in).
- ``load_reference_state``: a reference ``.pth`` blob (keys ``vf_net``,
  ``rendering_net``, ``density``; reference
  ``models/nerf/vector_field_nerf.py:196-214``). The port's modules use the
  reference layer naming natively (``layers.{i}.weight`` for a plain layer,
  ``layers.{i}.0.*`` / ``layers.{i}.1.*`` for Linear + BatchNorm; reference
  ``vector_field_network.py:47-60``), so this only strips a ``module.``
  DataParallel prefix and loads strictly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from vf_nerf_torch.models.renderer import VFNerfModules


def _modules(model_or_modules) -> VFNerfModules:
    if isinstance(model_or_modules, VFNerfModules):
        return model_or_modules
    return model_or_modules.modules


def _copy(dst: torch.Tensor, src: Any) -> None:
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _load_mlp(net: nn.Module, params: Mapping[str, Any],
              batch_stats: Mapping[str, Any]) -> None:
    for i, layer in enumerate(net.layers):
        scope = params[f"layer_{i}"]
        lin = layer[0] if isinstance(layer, nn.Sequential) else layer
        _copy(lin.weight, np.asarray(scope["Dense_0"]["kernel"]).T)
        _copy(lin.bias, scope["Dense_0"]["bias"])
        if isinstance(layer, nn.Sequential):
            bn = layer[1]
            stats = batch_stats[f"layer_{i}"]["BatchNorm_0"]
            _copy(bn.weight, scope["BatchNorm_0"]["scale"])
            _copy(bn.bias, scope["BatchNorm_0"]["bias"])
            _copy(bn.running_mean, stats["mean"])
            _copy(bn.running_var, stats["var"])


def load_jax_variables(model_or_modules, variables: Mapping[str, Any]) -> None:
    """Copy the JAX package's variables into a ``VectorFieldNerf`` or
    ``VFNerfModules``, on whatever device the modules live."""
    modules = _modules(model_or_modules)
    params, stats = variables["params"], variables.get("batch_stats", {})
    _load_mlp(modules.vf, params["vf"], stats.get("vf") or {})
    _load_mlp(modules.render, params["render"], stats.get("render") or {})
    density = params["density"]
    for name in ("beta", "scale", "mean"):
        value = density[name] if isinstance(density, Mapping) \
            else getattr(density, name)
        _copy(getattr(modules.density, name), value)


def _strip_module_prefix(state: Mapping[str, Any]) -> Dict[str, Any]:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def load_reference_state(model_or_modules,
                         blob: Union[str, Mapping[str, Any]]) -> int:
    """Load a reference checkpoint (a path or its loaded dict) into the
    modules; returns the saved epoch + 1."""
    if isinstance(blob, str):
        blob = torch.load(blob, map_location="cpu")
    modules = _modules(model_or_modules)
    for net, key in ((modules.vf, "vf_net"),
                     (modules.render, "rendering_net")):
        state = _strip_module_prefix(blob[key])
        state = {k: v for k, v in state.items()
                 if not k.endswith("num_batches_tracked")}
        missing, unexpected = net.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(f"{key}: missing {missing}, "
                           f"unexpected {unexpected}")
    density = _strip_module_prefix(blob["density"])
    for name in ("beta", "scale", "mean"):
        _copy(getattr(modules.density, name),
              torch.as_tensor(density[name]).detach().cpu().numpy())
    return int(blob.get("epoch", 0)) + 1
