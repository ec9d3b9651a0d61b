"""Weights carried into the port's modules.

- ``load_jax_variables``: the JAX package's variables as a numpy pytree
  (``params.{vf,render}.layer_i.{Dense_0,BatchNorm_0}``,
  ``batch_stats.{vf,render}.layer_i.BatchNorm_0.{mean,var}`` and
  ``params.density`` with ``beta/scale/mean`` as a dict or a named tuple).
  Dense kernels transpose from (in, out) to torch's (out, in).
- ``load_jax_train_state``: a JAX ``TrainState`` (params, batch_stats,
  opt_state, step) into a ``VectorFieldNerf`` and its optimizer: the Adam
  moments ``mu`` / ``nu`` leaf by leaf and the count, from the plain
  optax chain's ``ScaleByAdamState`` or the duplicate-VF optimizer's dict.
- ``load_reference_state``: a reference ``.pth`` blob (keys ``vf_net``,
  ``rendering_net``, ``density``; reference
  ``models/nerf/vector_field_nerf.py:196-214``). The port's modules use the
  reference layer naming natively (``layers.{i}.weight`` for a plain layer,
  ``layers.{i}.0.*`` / ``layers.{i}.1.*`` for Linear + BatchNorm; reference
  ``vector_field_network.py:47-60``), so this only strips a ``module.``
  DataParallel prefix and loads strictly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from vf_nerf_torch.models.nerf import param_groups
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


def jax_param_paths(modules: VFNerfModules
                    ) -> List[Tuple[Tuple[str, ...], torch.Tensor, bool]]:
    """Each trainable tensor with its path in the JAX params tree and
    whether the JAX leaf is its transpose (Dense kernels are (in, out))."""
    out = []
    for net_name, net in (("vf", modules.vf), ("render", modules.render)):
        for i, layer in enumerate(net.layers):
            scope = (net_name, f"layer_{i}")
            lin = layer[0] if isinstance(layer, nn.Sequential) else layer
            out.append((scope + ("Dense_0", "kernel"), lin.weight, True))
            out.append((scope + ("Dense_0", "bias"), lin.bias, False))
            if isinstance(layer, nn.Sequential):
                out.append((scope + ("BatchNorm_0", "scale"), layer[1].weight,
                            False))
                out.append((scope + ("BatchNorm_0", "bias"), layer[1].bias,
                            False))
    for name in ("beta", "scale", "mean"):
        out.append((("density", name), getattr(modules.density, name),
                    False))
    return out


def _leaf(tree: Any, path: Tuple[str, ...]) -> np.ndarray:
    for key in path:
        tree = tree[key] if isinstance(tree, Mapping) else getattr(tree, key)
    return np.asarray(tree)


def _adam_state(opt_state: Any):
    """(mu, nu, count) of either JAX optimizer's state."""
    if isinstance(opt_state, Mapping):
        return opt_state["mu"], opt_state["nu"], opt_state["count"]
    for part in opt_state:
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return part.mu, part.nu, part.count
    raise ValueError("no Adam moments in the optimizer state")


def load_jax_train_state(model, state: Any) -> None:
    """Carry a JAX ``TrainState`` (``params``, ``batch_stats``,
    ``opt_state``, ``step``; numpy or JAX leaves) into ``model`` (a
    ``VectorFieldNerf``): the weights, the optimizer's moments and count.
    Raises if the state's step and its optimizer count differ, since the
    port keeps one count."""
    load_jax_variables(model, {"params": state.params,
                               "batch_stats": state.batch_stats})
    mu, nu, count = _adam_state(state.opt_state)
    if int(np.asarray(state.step)) != int(np.asarray(count)):
        raise ValueError(f"step {int(np.asarray(state.step))} and optimizer "
                         f"count {int(np.asarray(count))} differ")
    opt = model.optimizer
    where = {id(p): (group, i)
             for group, params in param_groups(model.modules).items()
             for i, p in enumerate(params)}
    for path, param, transpose in jax_param_paths(model.modules):
        group, i = where[id(param)]
        for moments, dst in ((mu, opt.mu), (nu, opt.nu)):
            value = _leaf(moments, path)
            _copy(dst[group][i], value.T if transpose else value)
    opt.count = int(np.asarray(count))


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
