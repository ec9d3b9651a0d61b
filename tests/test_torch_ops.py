"""Parity of vf_nerf_torch's plain ops with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both functions; the
random draws of the samplers are JAX's own (``jax.random``, split exactly as
``render_rays`` and ``ops/samplers.py`` split them) handed to the port.
Tolerance is rtol 1e-4 / atol 1e-5 (f32 chains whose op order may differ)
and rtol 1e-6 where the math is the same op for op (embedding, rays).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vf_nerf_tpu.ops import annealing as jannealing
from vf_nerf_tpu.ops import compositing as jcompositing
from vf_nerf_tpu.ops import density as jdensity
from vf_nerf_tpu.config.schema import VFLossConfig as JLossConfig
from vf_nerf_tpu.config.schema import VFLossWeights as JLossWeights
from vf_nerf_tpu.models import loss as jloss
from vf_nerf_tpu.ops import embedding as jembedding
from vf_nerf_tpu.ops import points as jpoints
from vf_nerf_tpu.ops import rays as jrays
from vf_nerf_tpu.ops import samplers as jsamplers
from vf_nerf_tpu.ops import window as jwindow
from vf_nerf_torch.config import parse_config, schema
from vf_nerf_torch.models import loss
from vf_nerf_torch.ops import annealing, compositing, density, embedding
from vf_nerf_torch.ops import points, rays, samplers, window

CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")
RTOL, ATOL = 1e-4, 1e-5
EXACT = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(ours, ref, **kw):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               **(kw or dict(rtol=RTOL, atol=ATOL)))


def _camera(n, seed, pose7=False):
    rng = np.random.RandomState(seed)
    uv = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr[:, 0, 0] = rng.uniform(400, 700, n)
    intr[:, 1, 1] = rng.uniform(400, 700, n) * (-1 if seed % 2 else 1)
    intr[:, 0, 1] = rng.uniform(-2, 2, n)
    intr[:, 0, 2], intr[:, 1, 2] = 300.0, 250.0
    if pose7:
        q = rng.randn(n, 4).astype(np.float32)
        pose = np.concatenate([q, rng.randn(n, 3).astype(np.float32)], 1)
    else:
        a = rng.randn(n, 3, 3)
        rot = np.linalg.qr(a)[0].astype(np.float32)
        pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        pose[:, :3, :3] = rot
        pose[:, :3, 3] = rng.randn(n, 3)
    return uv, pose, intr


class TestEmbedding:
    @pytest.mark.parametrize("multires", [0, 1, 4, 6])
    def test_matches_jax(self, multires):
        x = np.random.RandomState(0).randn(17, 3).astype(np.float32) * 3
        ref = jembedding.positional_encoding(jnp.asarray(x), multires)
        ours = embedding.positional_encoding(_t(x), multires)
        assert embedding.embedding_dim(multires) == ref.shape[-1]
        _close(ours, ref, **EXACT)


class TestRays:
    @pytest.mark.parametrize("pose7", [False, True])
    @pytest.mark.parametrize("seed", [1, 2])
    def test_ray_directions(self, pose7, seed):
        uv, pose, intr = _camera(33, seed, pose7)
        ref = jrays.get_ray_directions_and_cam_location(
            jnp.asarray(uv), jnp.asarray(pose), jnp.asarray(intr))
        ours = rays.get_ray_directions_and_cam_location(
            _t(uv), _t(pose), _t(intr))
        for a, b in zip(ours, ref):
            _close(a, b, **EXACT)

    def test_quat_and_pose7(self):
        pose = np.random.RandomState(3).randn(9, 7).astype(np.float32)
        _close(rays.quat_to_rot(_t(pose[:, :4])),
               jrays.quat_to_rot(jnp.asarray(pose[:, :4])), **EXACT)
        _close(rays.pose7_to_matrix(_t(pose)),
               jrays.pose7_to_matrix(jnp.asarray(pose)), **EXACT)
        _close(rays.pixel_to_camera(_t(pose[:, 0]), _t(pose[:, 1]),
                                    _t(pose[:, 2]),
                                    _t(_camera(9, 4)[2])),
               jrays.pixel_to_camera(jnp.asarray(pose[:, 0]),
                                     jnp.asarray(pose[:, 1]),
                                     jnp.asarray(pose[:, 2]),
                                     jnp.asarray(_camera(9, 4)[2])), **EXACT)


def _jax_draws(key, n_rays, n_coarse, n_fine):
    """JAX's draws exactly as render_rays / samplers split the key."""
    k_coarse, k_fine = jax.random.split(key)
    t_coarse = jax.random.uniform(k_coarse, (n_rays, n_coarse), jnp.float32)
    k_strat, k_rand = jax.random.split(k_fine)
    t_fine = jsamplers._column_uniform(k_strat, n_rays, n_fine, jnp.float32)
    u_extra = jsamplers._column_uniform(k_rand, n_rays, n_fine, jnp.float32)
    return k_coarse, k_fine, t_coarse, t_fine, u_extra


class TestSamplers:
    @pytest.mark.parametrize("n", [1, 2, 3, 64, 100, 130, 200, 201])
    def test_linspace01_is_jax_linspace_bit_for_bit(self, n):
        """The samplers' linspace, at the counts the port takes it at
        (the coarse count, ``sample_pdf``'s deterministic ``u``), equals
        ``jnp.linspace`` bit for bit and ends exactly at 1.
        ``np.linspace`` rounds a float64 product to float32, so it may
        differ by one ulp inside."""
        ours = samplers._linspace01(n, torch.float32, "cpu").numpy()
        ref = np.asarray(jnp.linspace(0, 1, n))
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours.view(np.int32),
                                      ref.view(np.int32))
        assert ours[0] == 0.0 and (n == 1 or ours[-1] == 1.0)
        ulps = ours.view(np.int32).astype(np.int64) - np.linspace(
            0, 1, n, dtype=np.float32).view(np.int32)
        assert np.abs(ulps).max() <= 1

    @pytest.mark.parametrize("perturb", [True, False])
    def test_uniform_z_vals(self, perturb):
        key = jax.random.PRNGKey(7)
        k_coarse, _, t_coarse, _, _ = _jax_draws(key, 12, 100, 30)
        ref = jsamplers.uniform_z_vals(k_coarse, 12, 100, jnp.float32(0.0),
                                       jnp.float32(4.0), perturb=perturb)
        ours = samplers.uniform_z_vals(12, 100, 0.0, 4.0, perturb=perturb,
                                       t=_t(t_coarse))
        _close(ours, ref)

    @pytest.mark.parametrize("perturb", [True, False])
    def test_range_fine_both_branches(self, perturb):
        rng = np.random.RandomState(5)
        n_rays, n_coarse, n_fine = 24, 40, 12
        z = np.sort(rng.uniform(0.0, 4.0, (n_rays, n_coarse)), 1).astype(
            np.float32)
        w = rng.rand(n_rays, n_coarse).astype(np.float32)
        w[:8, 0] = 5.0          # argmax 0: the random-extras branch
        w[8:12, 3] = w[8:12, 7] = 9.0  # a tie: the first maximum wins
        _, k_fine, _, t_fine, u_extra = _jax_draws(
            jax.random.PRNGKey(11), n_rays, n_coarse, n_fine)
        ref = jsamplers.range_fine_z_vals(
            k_fine, jnp.asarray(z), jnp.asarray(w), n_fine, fine_range=0.3,
            near=0.0, far=4.0, perturb=perturb)
        ours = samplers.range_fine_z_vals(
            _t(z), _t(w), n_fine, 0.3, 0.0, 4.0, perturb, _t(t_fine),
            _t(u_extra))
        _close(ours, ref)
        assert int((torch.argmax(_t(w), -1) > 0).sum()) == 16

    @pytest.mark.parametrize("perturb", [True, False])
    @pytest.mark.parametrize("n_active", [1, 5, 12])
    def test_range_fine_static_growth(self, n_active, perturb):
        """``n_active`` live columns of a padded fine axis of 12: the live
        spacing, the last live column's stratify bound and the pad depths
        at far + 2·fine_range + 1, as JAX's traced ``n_active``."""
        rng = np.random.RandomState(6)
        n_rays, n_coarse, n_fine = 24, 40, 12
        z = np.sort(rng.uniform(0.0, 4.0, (n_rays, n_coarse)), 1).astype(
            np.float32)
        w = rng.rand(n_rays, n_coarse).astype(np.float32)
        w[:8, 0] = 5.0          # argmax 0: the random-extras branch
        _, k_fine, _, t_fine, u_extra = _jax_draws(
            jax.random.PRNGKey(13), n_rays, n_coarse, n_fine)
        ref = jsamplers.range_fine_z_vals(
            k_fine, jnp.asarray(z), jnp.asarray(w), n_fine, fine_range=0.3,
            near=jnp.float32(0.0), far=jnp.float32(4.0), perturb=perturb,
            n_active=jnp.asarray(n_active, jnp.int32))
        ours = samplers.range_fine_z_vals(
            _t(z), _t(w), n_fine, 0.3, 0.0, 4.0, perturb, _t(t_fine),
            _t(u_extra), n_active=n_active)
        _close(ours, ref)
        # The pads sort to the tail, beyond every live depth.
        pad = n_fine - n_active
        if pad:
            assert bool((ours[:, -pad:] > 4.0 + 0.6).all())
            assert bool((ours[:, :-pad] < 4.0 + 0.6 + 1.0).all())

    def test_points_from_z(self):
        rng = np.random.RandomState(2)
        cam, d = rng.randn(5, 3), rng.randn(5, 3)
        z = rng.rand(5, 7)
        _close(samplers.points_from_z(_t(cam), _t(d), _t(z)),
               jsamplers.points_from_z(*(jnp.asarray(a, jnp.float32)
                                         for a in (cam, d, z))), **EXACT)


class TestDensity:
    @pytest.mark.parametrize("beta,scale,mean,cutoff",
                             [(0.5, 100.0, 0.7, -0.5), (2e-5, -0.3, 1.7, -2.0),
                              (0.1, 50.0, 0.2, 0.0)])
    def test_laplace_density(self, beta, scale, mean, cutoff):
        x = np.linspace(-1.5, 1.5, 301).astype(np.float32)
        bounds = ((1e-4, 1e9), 1.0, (0.6, 1.0))
        jp = jdensity.DensityParams(*(jnp.float32(v)
                                      for v in (beta, scale, mean)))
        tp = density.DensityParams(*(torch.tensor(v)
                                     for v in (beta, scale, mean)))
        _close(density.laplace_density(_t(x), tp, *bounds, cutoff=cutoff),
               jdensity.laplace_density(jnp.asarray(x), jp, *bounds,
                                        cutoff=cutoff))
        for ours, ref in ((density.get_beta(tp, bounds[0]),
                           jdensity.get_beta(jp, bounds[0])),
                          (density.get_scale(tp, bounds[1]),
                           jdensity.get_scale(jp, bounds[1])),
                          (density.get_mean(tp, bounds[2]),
                           jdensity.get_mean(jp, bounds[2]))):
            _close(ours, ref, **EXACT)


class TestWindow:
    @pytest.mark.parametrize("n_samples", [10, 26, 130])
    @pytest.mark.parametrize("taps", ["uniform", "annealed"])
    def test_window_cosine(self, n_samples, taps):
        rng = np.random.RandomState(n_samples)
        normals = rng.randn(6, n_samples, 3).astype(np.float32)
        w = (np.full(11, 0.09, np.float32) if taps == "uniform" else
             np.asarray([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08, 0.04,
                         0.02, 0.01], np.float32))
        ref = jwindow.window_cosine_similarity(
            jnp.asarray(normals[:, :-1]), jnp.asarray(normals[:, 1:]),
            jnp.asarray(w))
        ours = window.window_cosine_similarity(
            _t(normals[:, :-1]), _t(normals[:, 1:]), _t(w))
        _close(ours, ref)
        _close(window.cosine_similarity(_t(normals), _t(normals[:, ::-1])),
               jwindow.cosine_similarity(jnp.asarray(normals),
                                         jnp.asarray(normals[:, ::-1])))


    @pytest.mark.parametrize("n_valid", [3, 14, 15, 16, 20, 32])
    @pytest.mark.parametrize("taps", ["uniform", "annealed"])
    def test_window_cosine_n_valid(self, n_valid, taps):
        """The live count at the window's edges: with 11 taps (start 7) and
        32 samples, n_valid ≤ 15 leaves no live interior, 16 one position,
        32 the whole interior (nothing masked)."""
        rng = np.random.RandomState(n_valid)
        normals = rng.randn(5, 32, 3).astype(np.float32)
        w = (np.full(11, 0.09, np.float32) if taps == "uniform" else
             np.asarray([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08, 0.04,
                         0.02, 0.01], np.float32))
        ref = jwindow.window_cosine_similarity(
            jnp.asarray(normals[:, :-1]), jnp.asarray(normals[:, 1:]),
            jnp.asarray(w), n_valid=jnp.asarray(n_valid, jnp.int32))
        ours = window.window_cosine_similarity(
            _t(normals[:, :-1]), _t(normals[:, 1:]), _t(w), n_valid=n_valid)
        _close(ours, ref)
        if n_valid == 32:
            _close(ours, window.window_cosine_similarity(
                _t(normals[:, :-1]), _t(normals[:, 1:]), _t(w)), **EXACT)


class TestPoints:
    @staticmethod
    def _jax_draw(key, n):
        """JAX's shell draw as ``sphere_shell_sample`` takes it, stacked as
        the port's (n, 3) [phi, cos_theta, u]."""
        k_phi, k_cos, k_u = jax.random.split(key, 3)
        return np.stack([
            np.asarray(jax.random.uniform(k_phi, (n,), jnp.float32, 0.0,
                                          2.0 * jnp.pi)),
            np.asarray(jax.random.uniform(k_cos, (n,), jnp.float32, -1.0,
                                          1.0)),
            np.asarray(jax.random.uniform(k_u, (n,), jnp.float32))], 1)

    @pytest.mark.parametrize("which", ["border", "center"])
    def test_shell_and_ball_samples(self, which):
        key = jax.random.PRNGKey(21)
        centroid = np.asarray([0.3, -0.2, 0.1], np.float32)
        draw = _t(self._jax_draw(key, 500))
        if which == "border":
            ref = jpoints.sample_border_points(key, 2.0, 3.0, 500,
                                               jnp.asarray(centroid))
            ours = points.sample_border_points(draw, 2.0, 3.0, _t(centroid))
        else:
            ref = jpoints.sample_center_points(key, jnp.asarray(centroid),
                                               0.15, 500)
            ours = points.sample_center_points(draw, _t(centroid), 0.15)
        for a, b in zip(ours, ref):
            _close(a, b)

    def test_shell_draw_from_a_generator(self):
        draw = points.shell_draw(4000, torch.Generator().manual_seed(0),
                                 "cpu")
        pts = points.sphere_shell_sample(draw, r_max=2.0, r_min=1.0)
        r = torch.linalg.vector_norm(pts, dim=1)
        assert bool((r >= 1.0 - 1e-6).all() and (r <= 2.0 + 1e-6).all())
        assert abs(float(pts.mean(0).abs().max())) < 0.1

    def test_masks_and_targets(self):
        rng = np.random.RandomState(4)
        pts = rng.uniform(-2, 2, (6, 30, 3)).astype(np.float32)
        centroid = np.asarray([0.1, 0.0, -0.1], np.float32)
        for ours, ref in (
                (points.border_mask_and_gt(_t(pts), 4.0, 0.15, _t(centroid)),
                 jpoints.border_mask_and_gt(jnp.asarray(pts), 4.0, 0.15,
                                            jnp.asarray(centroid))),
                (points.center_mask_and_gt(_t(pts), _t(centroid), 0.9),
                 jpoints.center_mask_and_gt(jnp.asarray(pts),
                                            jnp.asarray(centroid), 0.9))):
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
            assert 0 < int(ours[0].sum()) < ours[0].numel()
            _close(ours[1], ref[1])


class TestLoss:
    WEIGHTS = dict(rgb=2.0, depth=0.5, unit_norm=0.1, supervision=1.0,
                   norm_smaller_than_one=0.1, directional_derivatives=0.3)

    @pytest.mark.parametrize("epoch", [0, 11000])
    @pytest.mark.parametrize("sample_mask", [False, True])
    @pytest.mark.parametrize("mask_invalid_depth", [False, True])
    def test_vf_loss(self, epoch, sample_mask, mask_invalid_depth):
        rng = np.random.RandomState(epoch + 2 * sample_mask +
                                    4 * mask_invalid_depth)
        r, n = 12, 12 * 10
        preds = {"rgb": rng.rand(r, 3), "depth": rng.uniform(0, 3, (r, 1)),
                 "normals": rng.randn(n, 3) * 0.8,
                 "dir_derivative_norms": rng.rand(n)}
        gts = {"rgb": rng.rand(r, 3), "depth": rng.uniform(0, 3, (r, 1))}
        gts["depth"][::4] = 0.0          # sensor holes
        if sample_mask:
            preds["sample_mask"] = (rng.rand(n) < 0.7).astype(np.float32)
        terms = [(rng.randn(n, 3), rng.randn(n, 3), rng.rand(n) < 0.3),
                 (rng.randn(40, 3), rng.randn(40, 3),
                  (np.arange(40) < 25).astype(np.float32)),
                 (rng.randn(7, 3), rng.randn(7, 3), None)]
        config = dict(norm_smaller_than_one_start=11000,
                      depth_loss_clamp=0.5, directional_derivatives_start=100,
                      mask_invalid_depth=mask_invalid_depth)

        def jx(a):
            return None if a is None else jnp.asarray(np.asarray(
                a, np.float32 if np.asarray(a).dtype != bool else bool))

        def tx(a):
            if a is None:
                return None
            a = np.asarray(a)
            return torch.from_numpy(a if a.dtype == bool
                                    else a.astype(np.float32))

        ref_total, ref = jloss.vf_loss(
            {k: jx(v) for k, v in preds.items()},
            {k: jx(v) for k, v in gts.items()},
            [tuple(jx(a) for a in t) for t in terms],
            JLossWeights(**self.WEIGHTS), JLossConfig(**config),
            jnp.asarray(epoch))
        total, ours = loss.vf_loss(
            {k: tx(v) for k, v in preds.items()},
            {k: tx(v) for k, v in gts.items()},
            [tuple(tx(a) for a in t) for t in terms],
            schema.VFLossWeights(**self.WEIGHTS),
            schema.VFLossConfig(**config), epoch)
        _close(total, ref_total, rtol=1e-6, atol=1e-7)
        for k, v in ours.items():
            _close(v, ref[k], rtol=1e-6, atol=1e-7)
        for t in terms:
            for a, b in zip(loss.masked_sq_err(*(tx(x) for x in t)),
                            jloss.masked_sq_err(*(jx(x) for x in t))):
                _close(a, b, rtol=1e-6, atol=1e-7)


class TestCompositing:
    @pytest.mark.parametrize("normalize", [True, False])
    @pytest.mark.parametrize("white", [True, False])
    def test_volsdf_and_composite(self, normalize, white):
        rng = np.random.RandomState(9)
        z = np.sort(rng.uniform(0, 4, (10, 30)), 1).astype(np.float32)
        sigma = (rng.rand(10, 30) * 20).astype(np.float32)
        sigma[:, -1] = 0.0
        rgb = rng.rand(10, 30, 3).astype(np.float32)
        ref_w = jcompositing.volsdf_volume_rendering(
            jnp.asarray(z), jnp.asarray(sigma), normalize)
        ours_w = compositing.volsdf_volume_rendering(_t(z), _t(sigma),
                                                     normalize)
        _close(ours_w, ref_w)
        ref = jcompositing.composite_rgb_depth(ref_w, jnp.asarray(rgb),
                                               jnp.asarray(z), white)
        ours = compositing.composite_rgb_depth(ours_w, _t(rgb), _t(z), white)
        for a, b in zip(ours, ref):
            _close(a, b)


class TestAnnealing:
    @pytest.mark.parametrize("mode", ["none", "hard", "soft", "anneal_fine"])
    @pytest.mark.parametrize("epoch", [0, 700, 900, 1400, 3000])
    def test_annealed_window_weights(self, mode, epoch):
        base = np.full(11, 0.09, np.float32)
        np.testing.assert_array_equal(
            annealing.annealed_window_weights(base, mode, 700, 1400, epoch),
            jannealing.annealed_window_weights(base, mode, 700, 1400, epoch))


def test_parse_config_matches_jax():
    """The port's own copy of the config parser reads the shipped conf into
    the same values as the JAX package's."""
    import dataclasses

    from vf_nerf_tpu.config.parser import parse_config as jparse
    ours = parse_config(scene="office0", config_path=CONF)
    ref = jparse(scene="office0", config_path=CONF)
    for name in ("vf_net_config", "rendering_net_config",
                 "ray_sampler_config", "density_config", "scheduler_config"):
        assert dataclasses.asdict(getattr(ours.vf_nerf_config, name)) == \
            dataclasses.asdict(getattr(ref.vf_nerf_config, name)), name
    for name in ("cos_sim_weights", "cos_sim_weights_anneal", "rendering",
                 "normalize_rendering", "dir_to_normal_th", "anneal_start",
                 "anneal_end"):
        assert getattr(ours.vf_nerf_config, name) == \
            getattr(ref.vf_nerf_config, name), name
    assert ours.expname == ref.expname
