"""The port's fused MLP (``vf_nerf_torch/ops/fused_mlp.py``) against the JAX
package's: ``fold_dense_bn`` through ``load_jax_variables``, and
``fused_mlp`` on the CPU (its plain version) against JAX ``fused_mlp`` with
the Pallas kernel in interpret mode and against JAX ``mlp_reference``.
Tolerance rtol 1e-4 / atol 1e-5 (f32 products summed in another order).

The CUDA kernel runs only on a card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` check it there. Its arithmetic, 3xTF32 on the tensor
cores, is emulated here (``mlp_3xtf32``) and held to JAX ``mlp_reference``
at the shipped widths with the VF kernels scaled by 3.5, as
``chip_smoke.py`` scales them. ``PYTHONPATH=. python
tests/test_torch_fused_mlp.py`` (from the repository root)
prints the emulation's error and a single TF32 pass's.
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
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.ops.fused_mlp import (ACTS_PITCH, acts_shape, fused_mlp,
                                         hidden_views, mlp_backward_reference,
                                         mlp_reference, blocks_of_128)
from vf_nerf_torch.utils.weights import (load_jax_variables,
                                         load_reference_state)

CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")
TOL = dict(rtol=1e-4, atol=1e-5)
VF_GAIN = 3.5


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


def _saved_acts(weights, x, skip_at, fill=0.0):
    """The plain forward's hidden outputs in the kernel's save layout
    (``acts_shape``), the columns past each layer's width set to ``fill``."""
    acts = torch.full(acts_shape(weights, x.shape[0]), fill)
    h = x
    for i, (w, b) in enumerate(weights[:-1]):
        if i == skip_at:
            h = torch.cat([h, x], 1) / 2 ** 0.5
        h = torch.relu(h @ w + b)
        acts[i, :, :h.shape[1]] = h
    return acts


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


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("skip_at,final_act", [(None, "none"), (2, "tanh"),
                                               (None, "sigmoid"),
                                               (0, "tanh")])
def test_backward_matches_jax_vjp(skip_at, final_act, need_dx):
    """``mlp_backward_reference`` from the forward's saved hidden
    activations against ``jax.vjp`` of JAX ``mlp_reference``: the gradients
    to every kernel and bias and (when asked) to x."""
    weights = _random_weights(skip_at)
    x = np.random.RandomState(3).randn(97, 39).astype(np.float32)
    jw = [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]
    y, vjp = jax.vjp(lambda ws, xx: jfused.mlp_reference(ws, xx, skip_at,
                                                         final_act),
                     jw, jnp.asarray(x))
    dy = np.random.RandomState(4).randn(*y.shape).astype(np.float32)
    ref_w, ref_x = vjp(jnp.asarray(dy))
    tw = _torch_weights(weights)
    grads, dx = mlp_backward_reference(
        tw, torch.from_numpy(x), _saved_acts(tw, torch.from_numpy(x), skip_at),
        torch.from_numpy(np.asarray(y)), torch.from_numpy(dy), skip_at,
        final_act, need_dx=need_dx)
    for (gw, gb), (rw, rb) in zip(grads, ref_w):
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), **TOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), **TOL)
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_x), **TOL)


def _ragged_weights(dims, skip_at, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(dims) - 1):
        in_d = dims[i] + (dims[0] if skip_at == i else 0)
        out.append(((rng.randn(in_d, dims[i + 1]) / np.sqrt(in_d)).astype(
            np.float32), (rng.randn(dims[i + 1]) * 0.1).astype(np.float32)))
    return out


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("dims,skip_at,final_act", [
    ([39, 32, 32, 21, 32, 35], 3, "tanh"),   # a ragged layer into the skip
    ([45, 32, 30, 32, 3], None, "sigmoid"),
])
def test_padded_acts_give_jax_gradients(dims, skip_at, final_act, need_dx):
    """The saved activations in the kernel's layer-major padded layout
    (each layer's rows ``ACTS_PITCH`` wide; the columns past its width
    filled with NaN here, so a read of them would show), cut by
    ``hidden_views``, give ``mlp_backward_reference`` the gradients of
    ``jax.grad`` through JAX ``mlp_reference`` to every kernel, bias and x
    (rtol 1e-4 / atol 1e-5)."""
    weights = _ragged_weights(dims, skip_at, seed=5)
    tw = _torch_weights(weights)
    x = np.random.RandomState(6).uniform(-1, 1, (83, dims[0])).astype(
        np.float32)
    dy = np.random.RandomState(7).randn(83, dims[-1]).astype(np.float32)
    jw = [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]

    def loss(ws, xx):
        return jnp.sum(jfused.mlp_reference(ws, xx, skip_at, final_act) *
                       jnp.asarray(dy))

    ref_w, ref_x = jax.grad(loss, argnums=(0, 1))(jw, jnp.asarray(x))
    xt = torch.from_numpy(x)
    acts = _saved_acts(tw, xt, skip_at, fill=float("nan"))
    y = mlp_reference(tw, xt, skip_at, final_act)
    grads, dx = mlp_backward_reference(tw, xt, acts, y, torch.from_numpy(dy),
                                       skip_at, final_act, need_dx=need_dx)
    for (gw, gb), (rw, rb) in zip(grads, ref_w):
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), **TOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), **TOL)
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_x), **TOL)


def test_saved_activation_layout_of_the_shipped_nets():
    """The VF net saves 8 hidden layers and the colour net 4, each as
    (points, ACTS_PITCH) rows whose first columns are the layer's output
    (the 217-wide layer's view is 217 wide); a tensor of another shape is
    refused."""
    def layers(dims):
        return [(torch.zeros(a, b), torch.zeros(b))
                for a, b in zip(dims[:-1], dims[1:])]

    vf = layers([39, 256, 256, 256, 217, 256, 256, 256, 256, 259])
    assert acts_shape(vf, 5) == (8, 5, ACTS_PITCH) == (8, 5, 300)
    assert acts_shape(layers([289, 256, 256, 256, 256, 3]), 7) == (4, 7, 300)
    acts = torch.arange(8 * 5 * 300, dtype=torch.float32).reshape(8, 5, 300)
    views = hidden_views(acts, vf)
    assert [tuple(v.shape) for v in views] == \
        [(5, 256)] * 3 + [(5, 217)] + [(5, 256)] * 4
    assert all(v.stride() == (300, 1) for v in views)
    assert torch.equal(views[3], acts[3, :, :217])
    with pytest.raises(ValueError, match="shape"):
        hidden_views(torch.zeros(5, 2016), vf)


@pytest.mark.parametrize("n_points,blocks128", [
    (20480, 132),    # the step's shell / ball launch: 132 + 56 split blocks
    (204800, 1584),  # the step's fine VF and colour launches: + 32 split
    (102400, 792),   # the render's coarse launch: + 16 split
    (133120, 1040),  # the render's fine and colour launches: 7.9 rounds
    (8192, 0),       # VF init: 128 split blocks, one round
    (1, 0),
])
def test_blocks_of_128_on_132_sms(n_points, blocks128):
    """Whole rounds of 128-point blocks, the rest as 64-point split blocks
    where that takes fewer estimated rounds."""
    assert blocks_of_128(n_points, 132) == blocks128


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
    ours, updates = mods.vf(torch.from_numpy(pts))
    assert updates == {}
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
    ours, updates = mods.render(*map(torch.from_numpy,
                                     (pts, nrm, dirs, feats)))
    assert updates == {}
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


def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does, through an int32 bit view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mlp_3xtf32(weights, x, skip_at, final_act, passes=3):
    """The kernel's arithmetic: each operand split into hi = tf32(v) and
    lo = tf32(v - hi), each product a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in
    f32 (``passes=1``: a_hi·b_hi alone, a single TF32 pass)."""
    def split(v):
        hi = tf32_rn(v)
        return hi, tf32_rn(v - hi)

    embedded, h = x, x
    for i, (w, b) in enumerate(weights):
        if skip_at is not None and i == skip_at:
            h = torch.cat([h, embedded], dim=1) / np.sqrt(2.0)
        (ah, al), (wh, wl) = split(h), split(w)
        y = ah @ wh
        if passes == 3:
            y = al @ wh + ah @ wl + y
        h = y + b
        if i < len(weights) - 1:
            h = torch.relu(h)
    return torch.tanh(h) if final_act == "tanh" else torch.sigmoid(h)


def _gained_case(shipped, net, n=300, gain=VF_GAIN):
    """Folded weights (VF kernels x VF_GAIN), inputs, skip and activation
    at the shipped widths, as numpy arrays."""
    _, _, mods = shipped
    vf, rn = mods.folded_weights()
    rng = np.random.RandomState(7)
    if net == "vf":
        weights = [(w.numpy() * gain, b.numpy()) for w, b in vf]
        pts = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
        x = positional_encoding(pts, 6).numpy()
        return weights, x, mods.vf.skip_at, "tanh"
    weights = [(w.numpy(), b.numpy()) for w, b in rn]
    return weights, rng.uniform(-1, 1, (n, 289)).astype(np.float32), None, \
        "sigmoid"


def _emulation(shipped, net, gain=VF_GAIN):
    """(JAX f32 reference, float64 reference, {passes: emulation})."""
    weights, x, skip, act = _gained_case(shipped, net, gain=gain)
    jw = [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]
    ref = np.asarray(jfused.mlp_reference(jw, jnp.asarray(x), skip, act))
    tw = _torch_weights(weights)
    f64 = mlp_reference([(w.double(), b.double()) for w, b in tw],
                        torch.from_numpy(x).double(), skip, act).numpy()
    out = {p: mlp_3xtf32(tw, torch.from_numpy(x), skip, act, passes=p)
           .numpy() for p in (1, 3)}
    return ref, f64, out


@pytest.mark.parametrize("net,gain", [("vf", 1.0), ("render", 1.0),
                                      ("vf", VF_GAIN)])
def test_3xtf32_emulation_matches_jax_reference(shipped, net, gain):
    """The kernel's 3xTF32 arithmetic is of f32 grade at the shipped widths:
    within rtol 1e-4 / atol 1e-5 of JAX ``mlp_reference`` in f32. With the
    VF kernels gained by 3.5 the f32 rounding of any f32 chain exceeds that
    tolerance (JAX's own f32 chain misses float64 by it on some outputs), so
    there the emulation must be no farther from float64 than JAX's f32
    chain is."""
    ref, f64, out = _emulation(shipped, net, gain)
    assert out[3].shape == ref.shape
    if gain == 1.0:
        np.testing.assert_allclose(out[3], ref, **TOL)
    else:
        assert np.abs(out[3] - f64).max() <= np.abs(ref - f64).max()


def test_single_tf32_pass_is_not_f32_grade(shipped):
    """A single TF32 pass is far outside f32 grade on the gained VF net: the
    reason for the split."""
    ref, f64, out = _emulation(shipped, "vf")
    assert not np.allclose(out[1], ref, **TOL)
    assert np.abs(out[1] - f64).max() > 100 * np.abs(ref - f64).max()


if __name__ == "__main__":
    models = _shipped_models()
    for name, gain in (("vf", 1.0), ("vf", VF_GAIN), ("render", 1.0)):
        ref, f64, out = _emulation(models, name, gain)
        print(name, f"gain {gain}", {
            "jax_f32_vs_f64": float(np.abs(ref - f64).max()),
            **{f"{p}xtf32_vs_f64": float(np.abs(out[p] - f64).max())
               for p in (1, 3)},
            **{f"{p}xtf32_vs_jax_f32": float(np.abs(out[p] - ref).max())
               for p in (1, 3)}})
