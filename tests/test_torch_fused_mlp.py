"""The port's fused MLP (``vf_nerf_torch/ops/fused_mlp.py``) against the JAX
package's: ``fold_dense_bn`` through ``load_jax_variables``, and
``fused_mlp`` on the CPU (its plain version) against JAX ``fused_mlp`` with
the Pallas kernel in interpret mode and against JAX ``mlp_reference``.
Tolerance rtol 1e-4 / atol 1e-5 (f32 products summed in another order).

The CUDA kernel runs only on a card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` check it there.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vf_nerf_tpu.config.parser import parse_config as jparse
from vf_nerf_tpu.models.renderer import VFNerfModules as JModules
from vf_nerf_tpu.ops import fused_mlp as jfused
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.models.renderer import VFNerfModules
from vf_nerf_torch.ops.fused_mlp import fused_mlp
from vf_nerf_torch.utils.weights import (load_jax_variables,
                                         load_reference_state)

CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")
TOL = dict(rtol=1e-4, atol=1e-5)


def _random_weights(skip_at, seed=1):
    rng = np.random.RandomState(seed)
    dims = [39, 64, 64, 64, 32]
    out = []
    for i in range(len(dims) - 1):
        in_d = dims[i] + (dims[0] if skip_at == i else 0)
        out.append(((rng.randn(in_d, dims[i + 1]) * 0.2).astype(np.float32),
                    (rng.randn(dims[i + 1]) * 0.1).astype(np.float32)))
    return out


def _torch_weights(weights):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in weights]


@pytest.mark.parametrize("n_points", [300, 331])
@pytest.mark.parametrize("skip_at,final_act", [(None, "none"), (2, "tanh"),
                                               (None, "sigmoid")])
def test_matches_jax_pallas_kernel(skip_at, final_act, n_points):
    weights = _random_weights(skip_at)
    x = np.random.RandomState(2).randn(n_points, 39).astype(np.float32)
    jw = [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]
    pallas = jfused.fused_mlp(jw, jnp.asarray(x), skip_at=skip_at,
                              final_act=final_act, block_points=128,
                              use_pallas=True, interpret=True)
    xla = jfused.mlp_reference(jw, jnp.asarray(x), skip_at, final_act)
    ours = fused_mlp(_torch_weights(weights), torch.from_numpy(x),
                     skip_at=skip_at, final_act=final_act)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla), **TOL)


def _shipped_models(seed=0):
    """JAX and port modules at the shipped conf's widths with the same
    weights; BatchNorm statistics randomized so the fold does real work."""
    jcfg = jparse(scene="s", config_path=CONF).vf_nerf_config
    jmods = JModules(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmods.init_variables(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for net in ("vf", "render"):
        for scope in variables["batch_stats"][net].values():
            bn = scope["BatchNorm_0"]
            bn["mean"] = rng.randn(*bn["mean"].shape).astype(np.float32) * .1
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
        for scope in variables["params"][net].values():
            if "BatchNorm_0" in scope:
                bn = scope["BatchNorm_0"]
                bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(
                    np.float32)
                bn["bias"] = rng.randn(*bn["bias"].shape).astype(
                    np.float32) * 0.1
    mods = VFNerfModules(parse_config(scene="s", config_path=CONF)
                         .vf_nerf_config).eval()
    load_jax_variables(mods, variables)
    return jmods, variables, mods


@pytest.fixture(scope="module")
def shipped():
    return _shipped_models()


def test_fold_dense_bn_matches_jax(shipped):
    jmods, variables, mods = shipped
    j_vf, j_rn = jmods.folded_weights(variables)
    vf, rn = mods.folded_weights()
    assert [tuple(w.shape) for w, _ in vf] == \
        [(39, 256)] + [(256, 256)] * 2 + [(256, 217)] + \
        [(256, 256)] * 4 + [(256, 259)]
    assert [tuple(w.shape) for w, _ in rn] == \
        [(289, 256)] + [(256, 256)] * 3 + [(256, 3)]
    for ours, ref in zip(vf + rn, j_vf + j_rn):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("net", ["vf", "render"])
def test_shipped_widths_match_jax_pallas_kernel(shipped, net):
    jmods, variables, mods = shipped
    j_vf, j_rn = jmods.folded_weights(variables)
    vf, rn = mods.folded_weights()
    rng = np.random.RandomState(3)
    if net == "vf":
        jw, tw, skip, act = j_vf, vf, 4, "tanh"
        x = np.concatenate([rng.uniform(-1, 1, (253, 3))] +
                           [rng.uniform(-1, 1, (253, 36))], 1)
    else:
        jw, tw, skip, act = j_rn, rn, None, "sigmoid"
        x = rng.uniform(-1, 1, (253, 289))
    x = x.astype(np.float32)
    pallas = jfused.fused_mlp(jw, jnp.asarray(x), skip_at=skip,
                              final_act=act, block_points=128,
                              use_pallas=True, interpret=True)
    ours = fused_mlp(tw, torch.from_numpy(x), skip_at=skip, final_act=act)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **TOL)


def test_vf_net_forward_matches_flax(shipped):
    """The eval-mode nn.Module forward (unfolded BatchNorm) equals the Flax
    module's, and the folded path equals both."""
    jmods, variables, mods = shipped
    pts = np.random.RandomState(4).uniform(-1, 1, (97, 3)).astype(np.float32)
    ref = jmods.vf_apply(variables, jnp.asarray(pts), train=False)
    ours = mods.vf(torch.from_numpy(pts))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)
    folded = mods.vf_apply_folded(mods.vf.folded_weights(),
                                  torch.from_numpy(pts))
    np.testing.assert_allclose(folded.numpy(), np.asarray(ref), **TOL)


def test_render_net_forward_matches_flax(shipped):
    jmods, variables, mods = shipped
    rng = np.random.RandomState(5)
    pts, nrm, dirs = (rng.randn(61, 3).astype(np.float32) for _ in range(3))
    feats = rng.randn(61, 256).astype(np.float32)
    ref = jmods.render_apply(variables, *map(jnp.asarray,
                                             (pts, nrm, dirs, feats)),
                             train=False)
    ours = mods.render(*map(torch.from_numpy, (pts, nrm, dirs, feats)))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)


def test_reference_pth_layout_loads_like_jax_variables(shipped, tmp_path):
    """A reference-layout ``.pth`` (written by the JAX package's own
    exporter) loads into the port's modules to the same tensors as
    ``load_jax_variables``."""
    from vf_nerf_tpu.utils.torch_import import mlp_state_to_torch
    jmods, variables, mods = shipped
    cfg = jmods.cfg
    blob = {"epoch": 7, "density": {
        k: torch.tensor(float(getattr(variables["params"]["density"], k)))
        for k in ("beta", "scale", "mean")}}
    for key, net, ncfg in (("vf_net", "vf", cfg.vf_net_config),
                           ("rendering_net", "render",
                            cfg.rendering_net_config)):
        state = mlp_state_to_torch(
            variables["params"][net], variables["batch_stats"][net],
            n_layers=len(ncfg.dimensions) + 1, batch_norm=ncfg.batch_norm,
            weight_norm=ncfg.weight_norm)
        blob[key] = {"module." + k: v for k, v in state.items()}
    path = tmp_path / "ref.pth"
    torch.save(blob, path)
    fresh = VFNerfModules(parse_config(scene="s", config_path=CONF)
                          .vf_nerf_config).eval()
    assert load_reference_state(fresh, str(path)) == 8
    ref = dict(mods.state_dict())
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


def test_wrapper_never_falls_back():
    """A tensor that is neither on the CPU nor on CUDA is refused, and so is
    a width the layers do not take. (CUDA tensors without a built library:
    ``tests/test_torch_port_rules.py``.)"""
    weights = _torch_weights(_random_weights(None))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_mlp(weights, torch.empty((8, 39), device="meta"))
    with pytest.raises(ValueError, match="width"):
        fused_mlp(weights, torch.zeros((8, 40)))
