"""The port's library leftovers against the JAX package's, on the CPU, on
seeded inputs:

- ``ops/ndc.py::convert_to_ndc`` (rtol 1e-6, atol 1e-6);
- ``samplers.sample_pdf`` and ``pdf_z_vals``, with JAX's uniforms passed in
  and deterministic (rtol 1e-5, atol 1e-6: a cumulative sum of 20 weights
  in another order; a deterministic uniform on a cdf node left out);
- the density alternates ``sdf_density`` (and ``laplace_density_sdf``),
  ``simple_density``, ``exponential_density``, ``sigmoid_density``
  (rtol 1e-6, atol 1e-7);
- ``parameter_linear_annealing`` and the three schedules of
  ``utils/schedules.py`` (their ``as_schedule()`` against JAX's
  ``as_optax()``, rtol 1e-6);
- ``NerfOutput`` and the facade's ``render_output`` against JAX's
  ``NerfOutput.from_render_dict`` of the same render dict.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_renderer import tiny_config
from test_torch_render import camera, port_config
from vf_nerf_tpu.models.output import NerfOutput as JNerfOutput
from vf_nerf_tpu.ops import annealing as jannealing
from vf_nerf_tpu.ops import density as jdensity
from vf_nerf_tpu.ops import ndc as jndc
from vf_nerf_tpu.ops import samplers as jsamplers
from vf_nerf_tpu.utils import schedules as jschedules
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.output import NerfOutput
from vf_nerf_torch.ops import annealing, density, ndc, samplers
from vf_nerf_torch.utils import schedules

RNG = np.random.RandomState(0)


def both(arr):
    return torch.from_numpy(arr), jnp.asarray(arr)


def test_convert_to_ndc_equals_jax():
    origins = RNG.randn(64, 3).astype(np.float32) * 0.3
    directions = RNG.randn(64, 3).astype(np.float32)
    directions[:, 2] = -np.abs(directions[:, 2]) - 0.5
    intr = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    intr[:, 0, 0] = intr[:, 1, 1] = 400.0
    intr[:, 0, 2], intr[:, 1, 2] = 319.5, 239.5
    ours = ndc.convert_to_ndc(*(torch.from_numpy(a) for a in
                                (origins, directions, intr)), near=1.5)
    theirs = jndc.convert_to_ndc(*(jnp.asarray(a) for a in
                                   (origins, directions, intr)), near=1.5)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("deterministic", [False, True])
def test_pdf_sampling_equals_jax(deterministic):
    n_rays, n_coarse, n_new = 32, 22, 12
    z = np.sort(RNG.uniform(0.5, 4.0, (n_rays, n_coarse)), axis=1).astype(
        np.float32)
    w = RNG.rand(n_rays, n_coarse).astype(np.float32) ** 4
    w[:4] = 0.0                                # flat pdf rays
    key = jax.random.PRNGKey(7)
    # JAX draws u inside sample_pdf from the key as given.
    u = np.array(jax.random.uniform(key, (n_rays, n_new), jnp.float32))
    (zt, zj), (wt, wj) = both(z), both(w)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    kw = {} if deterministic else dict(u=torch.from_numpy(u))
    # A deterministic u on a cdf node (u = 1 against a total of 1 ± 1 ulp,
    # the packages' f32 cumulative sums differing by an ulp) falls in
    # either bin: such samples are left out (the last of each ray here),
    # and pdf_z_vals is held on the rays where every sample agrees.
    if deterministic:
        u = np.linspace(0.0, 1.0, n_new, dtype=np.float32)[None].repeat(
            n_rays, 0)
    pdf = w[:, 1:-1] + 1e-5
    cdf = np.cumsum(pdf / pdf.sum(-1, keepdims=True), -1, dtype=np.float64)
    off_node = np.abs(u[:, :, None] - cdf[:, None, :]).min(2) >= 1e-6
    assert off_node.mean() > 0.9
    ours = samplers.sample_pdf(torch.from_numpy(mids), wt[:, 1:-1], n_new,
                               deterministic, **kw).numpy()
    theirs = np.asarray(jsamplers.sample_pdf(key, jnp.asarray(mids),
                                             wj[:, 1:-1], n_new,
                                             deterministic))
    np.testing.assert_allclose(ours[off_node], theirs[off_node], rtol=1e-5,
                               atol=1e-6)
    rays = np.isclose(ours, theirs, rtol=1e-5, atol=1e-6).all(1)
    assert rays.sum() >= 24
    ours = samplers.pdf_z_vals(zt, wt, n_new, deterministic, **kw)
    theirs = jsamplers.pdf_z_vals(key, zj, wj, n_new, deterministic)
    assert ours.shape == (n_rays, n_coarse + n_new)
    np.testing.assert_allclose(ours.numpy()[rays], np.asarray(theirs)[rays],
                               rtol=1e-5, atol=1e-6)
    if not deterministic:
        with pytest.raises(ValueError, match="uniforms"):
            samplers.sample_pdf(zt, wt, n_new)


def test_density_alternates_equal_jax():
    x = RNG.uniform(-2, 2, (200,)).astype(np.float32)
    (xt, xj) = both(x)
    beta, scale = 0.3, -3.0
    cases = [
        ("sdf_density", (beta,)), ("laplace_density_sdf", (beta,)),
        ("simple_density", ()), ("exponential_density", (beta,)),
        ("sigmoid_density", (beta, scale)),
        ("sigmoid_density", (1e-6, 0.5)),       # both clamps act
    ]
    for name, params in cases:
        ours = getattr(density, name)(
            xt, *(torch.tensor(p, dtype=torch.float32) for p in params))
        theirs = getattr(jdensity, name)(
            xj, *(jnp.asarray(p, jnp.float32) for p in params))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert density.laplace_density_sdf is density.sdf_density


def test_annealing_and_schedules_equal_jax():
    for args in ((1.0, 0.0, 10, 0), (1.0, 0.0, 10, 5), (1.0, 0.0, 10, 20),
                 (0.2, 0.8, 7, 3), (2.0, 1.0, 4, -1)):
        assert annealing.parameter_linear_annealing(*args) == \
            jannealing.parameter_linear_annealing(*args)
    for name, kw in (("ConstantLearningRateSchedule",
                      dict(learning_rate=0.1)),
                     ("StepLearningRateSchedule",
                      dict(learning_rate=0.1, frequency=10, decay_rate=0.5)),
                     ("ExponentialRateSchedule",
                      dict(learning_rate=5e-4, decay_rate=0.999))):
        ours, theirs = getattr(schedules, name)(**kw), \
            getattr(jschedules, name)(**kw)
        fn, jfn = ours.as_schedule(), theirs.as_optax()
        for count in (0, 1, 3, 25, 999, 5000):
            assert ours.get_learning_rate(count) == \
                theirs.get_learning_rate(count)
            np.testing.assert_allclose(fn(count), float(jfn(count)),
                                       rtol=1e-6, err_msg=f"{name} {count}")
        ours.load_state_dict({**kw, "learning_rate": 0.25})
        theirs.load_state_dict({**kw, "learning_rate": 0.25})
        assert ours == dataclasses.replace(ours, **dataclasses.asdict(
            theirs))


def test_nerf_output_and_render_output_equal_jax():
    model = VectorFieldNerf(port_config(tiny_config()), device="cpu")
    model.near, model.far = 0.0, 4.0
    uv, pose, intr = camera(8, 3, size=40.0, focal=30.0)
    model.generator.manual_seed(2)
    out = model.render_output(pose, uv, intr, epoch=0)
    model.generator.manual_seed(2)
    render = model.render(pose, uv, intr, epoch=0)
    ref = JNerfOutput.from_render_dict(
        {k: jnp.asarray(v.numpy()) for k, v in render.items()
         if isinstance(v, torch.Tensor)})
    assert isinstance(out, NerfOutput)
    assert sorted(out.to_dict()) == sorted(ref.to_dict())
    for k, v in ref.to_dict().items():
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(v),
                                      err_msg=k)
    assert not out.fine_active() and ref.fine_active() is False
    np.testing.assert_array_equal(out.get_normals().numpy(),
                                  np.asarray(ref.get_normals()))
    wrapped = NerfOutput.from_render_dict(dict(render,
                                               dir_derivative_norms=None))
    assert "directional_derivtives" not in wrapped.to_dict()
