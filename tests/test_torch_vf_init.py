"""The port's VF initialisation against the JAX package's, on the CPU.

- ``fit_vf_init`` of both packages on the tiny VF net of
  ``tests/test_e2e.py`` (3×32, skip at 2, 16 features), the port started
  from JAX's ``net.init(PRNGKey(seed))`` weights and fed JAX's points
  (the key chain of ``vf_nerf_tpu/train/vf_init.py:82-85``). After 20 Adam
  steps at lr 1e-3 every parameter is within 1e-3·lr of JAX's (a step moves
  a parameter by up to ~lr, so that is 0.1 % of one step; measured 1.2e-7,
  one f32 ulp of the largest weights), and the losses of every step agree
  to rtol 1e-5.
- A ``.pkl`` written by either package loads in the other through
  ``load_vf_init`` and gives the same field (rtol 1e-5).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import port_config
from vf_nerf_tpu.config.schema import VFNetConfig as JVFNetConfig
from vf_nerf_tpu.models.networks import VectorFieldMLP as JVectorFieldMLP
from vf_nerf_tpu.models.nerf import VectorFieldNerf as JVectorFieldNerf
from vf_nerf_tpu.train import vf_init as jvf_init
from vf_nerf_torch.config import schema
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.train import vf_init
from vf_nerf_torch.utils.weights import export_jax_vf_variables

import __graft_entry__ as graft

TINY = dict(input_dims=3, output_dims=3, dimensions=[32, 32, 32],
            feature_vector_dims=16, embedder_multires=4, weight_norm=False,
            batch_norm=True, skip_connection_in=[2], bias_init=0.0,
            dropout=False, dropout_probability=0.2, xavier_init=False,
            init="")
STEPS, BATCH, LR, SEED = 20, 1024, 1e-3, 0
RADIUS = 2.5
EXTENT = 1.5 * RADIUS
CENTROID = np.array([0.1, -0.2, 0.05], np.float32)
PARAM_ATOL = 1e-3 * LR


def jax_points(seed, steps, batch, centroid, extent):
    """The points of each JAX step, from the key chain of ``fit_vf_init``
    (the init key is also the chain's first key)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        k_pts, key = jax.random.split(key)
        out.append(np.asarray(jnp.asarray(centroid) + extent *
                              jax.random.uniform(k_pts, (batch, 3),
                                                 minval=-1.0, maxval=1.0)))
    return out


@pytest.fixture(scope="module")
def fitted():
    jcfg = JVFNetConfig(**TINY)
    j_params, j_stats = jvf_init.fit_vf_init(
        jcfg, "exterior_scene", CENTROID, sample_extent=EXTENT,
        wall_radius=RADIUS, steps=STEPS, batch=BATCH, lr=LR, seed=SEED)
    init = jax.tree_util.tree_map(np.asarray, JVectorFieldMLP(jcfg).init(
        jax.random.PRNGKey(SEED), jnp.zeros((8, 3)), train=False))
    pts = jax_points(SEED, STEPS, BATCH, CENTROID, EXTENT)
    net, losses = vf_init.fit_vf_init(
        schema.VFNetConfig(**TINY), "exterior_scene", CENTROID,
        sample_extent=EXTENT, wall_radius=RADIUS, steps=STEPS, lr=LR,
        device="cpu", points=lambda i: torch.tensor(pts[i]), init=init)
    return dict(j_params=j_params, j_stats=j_stats, net=net, losses=losses,
                pts=pts, init=init)


def _jax_losses(fitted):
    """JAX's loss at each step, recomputed from the recorded points along
    its own trajectory (``fit_vf_init`` returns only the final weights)."""
    import optax
    jcfg = JVFNetConfig(**TINY)
    net = JVectorFieldMLP(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, fitted["init"]["params"])
    stats = fitted["init"]["batch_stats"]
    tx = optax.adam(LR)
    state = tx.init(params)

    @jax.jit
    def step(params, state, pts):
        target = jvf_init.target_field(pts, "exterior_scene",
                                       jnp.asarray(CENTROID), RADIUS)

        def loss_fn(p):
            out = net.apply({"params": p, "batch_stats": stats}, pts,
                            train=False)
            return jnp.mean((out[:, :3] - target) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for pts in fitted["pts"]:
        params, state, loss = step(params, state, jnp.asarray(pts))
        losses.append(float(loss))
    return np.asarray(losses), jax.tree_util.tree_map(np.asarray, params)


def test_fit_matches_jax(fitted):
    params, stats = export_jax_vf_variables(fitted["net"])
    flat = jax.tree_util.tree_leaves_with_path(fitted["j_params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(params))
    for path, ref in flat:
        ours = params
        for key in path:
            ours = ours[key.key]
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))
    # Frozen BatchNorm: the statistics stay at their init.
    for name, scope in stats.items():
        ref = fitted["j_stats"][name]["BatchNorm_0"]
        np.testing.assert_array_equal(scope["BatchNorm_0"]["mean"],
                                      ref["mean"])
        np.testing.assert_array_equal(scope["BatchNorm_0"]["var"],
                                      ref["var"])
    j_losses, j_params = _jax_losses(fitted)
    np.testing.assert_allclose(fitted["losses"].numpy(), j_losses, rtol=1e-5)
    assert j_losses[-1] < j_losses[0]
    # The recomputed trajectory is the one fit_vf_init took (another
    # compiled program: equal to rounding).
    for a, b in zip(jax.tree_util.tree_leaves(j_params),
                    jax.tree_util.tree_leaves(fitted["j_params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)


def _shipped_like_config(vf):
    """The tiny graft config with the tiny VF net of this file."""
    jcfg = graft._tiny_config()
    import dataclasses
    return dataclasses.replace(jcfg, vf_net_config=JVFNetConfig(**vf))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pkl_loads_in_both_packages(fitted, writer, tmp_path):
    """A ``.pkl`` of either package gives the same field in both."""
    path = str(tmp_path / "init.pkl")
    if writer == "jax":
        with open(path, "wb") as f:
            pickle.dump({"params": fitted["j_params"],
                         "batch_stats": fitted["j_stats"],
                         "mode": "exterior_scene", "radius": RADIUS}, f)
    else:
        vf_init.save_vf_init(path, fitted["net"], "exterior_scene", RADIUS)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert set(blob) == {"params", "batch_stats", "mode", "radius"}

    jcfg = _shipped_like_config(TINY)
    jmodel = JVectorFieldNerf(jcfg)
    jmodel.load_vf_init(path)
    model = VectorFieldNerf(port_config(jcfg), device="cpu")
    model.load_vf_init(path)
    assert model.step == 0
    pts = np.random.RandomState(4).uniform(-3, 3, (500, 3)).astype(
        np.float32)
    ours = model.get_vector_field(pts).numpy()
    ref = np.asarray(jmodel.get_vector_field(pts))
    assert ours.shape == (500, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    # The file replaced the facade's own init.
    fresh = VectorFieldNerf(port_config(jcfg), device="cpu")
    assert np.abs(fresh.get_vector_field(pts).numpy() - ours).max() > 1e-3
