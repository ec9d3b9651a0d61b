"""The port's mesh stack against the JAX package's, on the CPU.

Inputs are made with numpy seeds and go through both packages:

- bit for bit: the marching-cubes tables (the classic one under
  ``VFNERF_CLASSIC_MC_TABLE``), the numpy field ops, the grid points (as
  XLA rounds them when it jits the JAX extractor), the unit field and
  norms, the divergence mask (exact except cells within 1e-6 of the
  threshold), the corner classification on grids with exact ties
  (constant cells, antipodal corners, axis vectors), the native and numpy
  triangle emission and the dedup, the host pipeline, classic marching
  cubes, TSDF fusion, the depth rasterizer, refuse, PLY files both ways;
- ``smooth_vf``: bit for bit against JAX's eager passes, and within rtol
  1e-6 of the summed magnitude against the jitted ones (XLA's fusion sums
  in another order);
- ``DeviceMeshExtractor`` on the analytic box field: identical meshes when
  both pipelines read one field function (the smoothed variants, whose
  grids differ in the last bits, within the near-identity rule at a median
  of 1e-6), and within the near-identity rule of
  ``tests/test_device_pipeline.py`` (vertex counts within 2 %, median
  nearest-neighbour distance < 1e-5, max < 2 voxels) when each package
  computes the field itself; over 8 octants ``extract_many`` equals the
  extracts one by one and JAX's;
- the model path: JAX weights through ``load_jax_variables`` and the port's
  ``marching_cubes_mesh`` / ``quadrant_marching_cubes`` against JAX's at
  res 32, under the near-identity rule (the two fused MLPs round apart).
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_torch_render import port_config
from test_torch_train_step import tiny_variables
from vf_nerf_tpu.datasets.synthetic import SyntheticBoxDataset as JBox
from vf_nerf_tpu.evaluation import methods as jmethods
from vf_nerf_tpu.evaluation import renderer as jrenderer
from vf_nerf_tpu.evaluation.mc import classic as jclassic
from vf_nerf_tpu.evaluation.mc import classic_tables as jclassic_tables
from vf_nerf_tpu.evaluation.mc import contrastive as jcontrastive
from vf_nerf_tpu.evaluation.mc import device_pipeline as jdp
from vf_nerf_tpu.evaluation.mc import field_ops as jfield_ops
from vf_nerf_tpu.evaluation.mc import pipeline as jpipeline
from vf_nerf_tpu.evaluation.mc import smoothing as jsmoothing
from vf_nerf_tpu.evaluation.mc import tables as jtables
from vf_nerf_tpu.evaluation.mc import tsdf as jtsdf
from vf_nerf_tpu.models.nerf import VectorFieldNerf as JVectorFieldNerf
from vf_nerf_tpu.utils import ply as jply
from vf_nerf_torch.datasets.synthetic import SyntheticBoxDataset
from vf_nerf_torch.evaluation import methods, renderer
from vf_nerf_torch.evaluation.mc import (classic, classic_tables, contrastive,
                                         device_pipeline, field_ops,
                                         pipeline, smoothing, tables, tsdf)
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import ply
from vf_nerf_torch.utils.weights import load_jax_variables


def box_field_np(half=1.0):
    """The analytic box field of ``tests/test_mesh_stack.py`` on numpy."""
    def fn(p):
        p = np.asarray(p, np.float32)
        dist = half - np.abs(p)
        inside = (dist > 0).all(-1)
        rows = np.arange(len(p))
        axis = np.argmin(dist, -1)
        sign = np.sign(p[rows, axis])
        sign = np.where(sign == 0, 1.0, sign)
        v_in = np.zeros_like(p)
        v_in[rows, axis] = sign
        closest = np.clip(p, -half, half)
        delta = closest - p
        v_out = delta / np.maximum(np.linalg.norm(delta, axis=-1,
                                                  keepdims=True), 1e-8)
        v = np.where(inside[:, None], v_in, v_out)
        udf = np.where(dist.min(-1) > 0, dist.min(-1),
                       np.linalg.norm(p - closest, axis=-1))
        return (v * np.maximum(udf, 1e-4)[:, None]).astype(np.float32)
    return fn


def box_field_torch(half=1.0):
    """The same field in torch, as the port's extractor calls it."""
    def fn(p):
        dist = half - p.abs()
        inside = (dist > 0).all(-1)
        axis = dist.argmin(-1)
        rows = torch.arange(p.shape[0])
        sign = torch.sign(p[rows, axis])
        sign = torch.where(sign == 0, 1.0, sign)
        v_in = torch.zeros_like(p)
        v_in[rows, axis] = sign
        closest = p.clamp(-half, half)
        delta = closest - p
        v_out = delta / torch.clamp(torch.linalg.vector_norm(
            delta, dim=-1, keepdim=True), min=1e-8)
        v = torch.where(inside[:, None], v_in, v_out)
        udf = torch.where(dist.amin(-1) > 0, dist.amin(-1),
                          torch.linalg.vector_norm(p - closest, dim=-1))
        return v * torch.clamp(udf, min=1e-4)[:, None]
    return fn


def shared_field(fn_np):
    """One numpy field as a JAX function and as a torch function, so both
    extractors read the same values."""
    def jax_fn(p):
        return jax.pure_callback(
            lambda q: fn_np(np.asarray(q)),
            jax.ShapeDtypeStruct(p.shape, jnp.float32), p)

    def torch_fn(p):
        return torch.from_numpy(fn_np(p.numpy()))
    return jax_fn, torch_fn


def assert_same_mesh(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def assert_near_identical(ours, ref, voxel, median=1e-5):
    """The near-identity rule of ``tests/test_device_pipeline.py``."""
    assert len(ours[0]) > 0 and len(ref[0]) > 0
    assert abs(len(ours[0]) - len(ref[0])) <= 0.02 * len(ref[0])
    d = cKDTree(ref[0]).query(ours[0], k=1)[0]
    assert np.median(d) < median
    assert d.max() < 2 * voxel


# ------------------------------------------------------------------ tables

def test_tables_equal_jax():
    for name in ("CORNER_OFFSETS", "EDGE_VERTEX", "EDGE_TABLE", "TRI_TABLE",
                 "COMB_I", "COMB_J", "PAIR_TO_COMB", "CORNER_COMB",
                 "CORNER_LANE"):
        ours, theirs = getattr(tables, name), getattr(jtables, name)
        assert ours.dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    np.testing.assert_array_equal(classic_tables.CLASSIC_TRI_TABLE,
                                  jclassic_tables.CLASSIC_TRI_TABLE)
    assert classic_tables.FLAG == jclassic_tables.FLAG


@pytest.mark.parametrize("flag", [None, "", "0", "false", "1", "true"])
def test_classic_table_flag_read_at_call_time(flag, monkeypatch):
    if flag is None:
        monkeypatch.delenv(classic_tables.FLAG, raising=False)
    else:
        monkeypatch.setenv(classic_tables.FLAG, flag)
    assert classic_tables.use_classic_tri_table() == \
        jclassic_tables.use_classic_tri_table()
    np.testing.assert_array_equal(contrastive.active_tri_table(),
                                  jcontrastive._active_tri_table())


# --------------------------------------------------------------- field ops

def _random_field(n=12, seed=0):
    return np.random.RandomState(seed).randn(n, n, n, 3).astype(np.float32)


def test_numpy_field_ops_equal_jax():
    vf = _random_field()
    surface = field_ops.extract_divergence(vf)
    np.testing.assert_array_equal(surface, jfield_ops.extract_divergence(vf))
    cells = np.argwhere(surface > 0.5)
    assert len(cells) > 10
    vt = vf / np.linalg.norm(vf, axis=-1, keepdims=True)
    norms = np.linalg.norm(vf, axis=-1)
    choice = field_ops.unify_direction(surface, vt, cells)
    np.testing.assert_array_equal(
        choice, jfield_ops.unify_direction(surface, vt, cells))
    for a, b in zip(field_ops.make_comb_format(choice, norms, cells),
                    jfield_ops.make_comb_format(choice, norms, cells)):
        np.testing.assert_array_equal(a, b)
    pairs = field_ops.pair_corner_values(vt, cells)
    np.testing.assert_array_equal(pairs,
                                  jfield_ops.pair_corner_values(vt, cells))
    pts = np.random.RandomState(1).rand(*pairs.shape).astype(np.float32)
    np.testing.assert_array_equal(
        field_ops.easy_convergence_points(pairs, pts, 0.1),
        jfield_ops.easy_convergence_points(pairs, pts, 0.1))


@pytest.mark.parametrize("k,sigma", [(3, 1.0), (9, 2.0)])
def test_smooth_vf_equals_jax(k, sigma):
    """Bit for bit against JAX's eager passes, whose sums run in the same
    order; against its jitted ones (which the extractor runs, and whose
    fusion sums otherwise) within rtol 1e-6 of the magnitude of the summed
    terms, the smoothing of |vf| (a sum near 0 has no relative precision)."""
    vf = _random_field(14, seed=k)
    ours = smoothing.smooth_vf(torch.from_numpy(vf), k=k, sigma=sigma)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jsmoothing.smooth_vf(jnp.asarray(vf), k,
                                                      sigma)))
    jitted = np.asarray(jax.jit(jsmoothing.smooth_vf, static_argnums=(1, 2))(
        jnp.asarray(vf), k, sigma))
    magnitude = np.asarray(jsmoothing.smooth_vf(jnp.asarray(np.abs(vf)), k,
                                                sigma))
    assert (np.abs(ours.numpy() - jitted) <= 1e-6 * magnitude).all()
    np.testing.assert_array_equal(smoothing.smooth_vf_np(vf, k, sigma),
                                  jsmoothing.smooth_vf_np(vf, k, sigma))
    np.testing.assert_array_equal(smoothing.gaussian_kernel_1d(k, sigma),
                                  jsmoothing.gaussian_kernel_1d(k, sigma))


# ------------------------------------------------------ device-stage pieces

@pytest.mark.parametrize("res,scale,offset", [
    (32, 1.5, (0.0, 0.0, 0.0)), (17, 2.2, (0.1, -0.25, 0.3)),
    (512, 1.1, (0.55, -0.55, 0.55))])
def test_grid_points_equal_jax_bit_for_bit(res, scale, offset):
    n = res ** 3
    # At res 512, the first and last 50k points (int64 flat indices).
    idx = np.arange(n) if n < 1e6 else np.concatenate(
        [np.arange(50_000), np.arange(n - 50_000, n)])
    off = np.asarray(offset, np.float32)
    theirs = np.asarray(jax.jit(jdp._grid_points, static_argnums=0)(
        res, jnp.float32(scale), jnp.asarray(off),
        jnp.asarray(idx, jnp.int32)))
    ours = device_pipeline.grid_points(res, scale, torch.from_numpy(off),
                                       torch.from_numpy(idx))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def _grids():
    """A random field, and the analytic box field on a grid."""
    box = box_field_np(1.0)(jpipeline.sample_grid(
        24, 1.5, np.zeros(3), np.zeros(3, np.float32))).reshape(24, 24, 24, 3)
    return [_random_field(16, seed=3), box]


@pytest.mark.parametrize("which", [0, 1])
def test_normalize_and_surface_mask_equal_jax(which):
    grid = _grids()[which]
    jvt, jnorms = [np.asarray(a) for a in
                   jax.jit(jdp._normalize_grid)(jnp.asarray(grid))]
    vt, norms = device_pipeline.normalize_grid(torch.from_numpy(grid))
    np.testing.assert_array_equal(vt.numpy(), jvt)
    np.testing.assert_array_equal(norms.numpy(), jnorms)
    theirs = np.asarray(jax.jit(jdp.surface_mask)(jnp.asarray(jvt)))
    ours = device_pipeline.surface_mask(vt).numpy()
    assert theirs.sum() > 0
    # Cells within 1e-6 of the threshold may flip (float64 divergence).
    div = np.zeros_like(ours[:-1, :-1, :-1], np.float64)
    v = jvt.astype(np.float64)
    n = len(v)
    for i in range(8):
        off = ((i // 4) % 2, (i // 2) % 2, i % 2)
        d = v[off[0]:off[0] + n - 1, off[1]:off[1] + n - 1,
              off[2]:off[2] + n - 1] @ (np.array(off) * 2.0 - 1) / np.sqrt(3)
        div += d * np.abs(d) * field_ops.FACE_AREA
    div /= field_ops.SHAPE_VOLUME
    settled = np.ones_like(ours)
    settled[:-1, :-1, :-1] = np.abs(div + 0.5) > 1e-6
    np.testing.assert_array_equal(ours[settled], theirs[settled])


def _tie_grid():
    """A random grid with exact ties: a block of one constant vector (every
    ``1 − dots`` entry 0), a block of antipodal halves (±x, every pair
    either 0 or 2), and a block of axis vectors (many equal maxima)."""
    g = _random_field(14, seed=5)
    g[2:6, 2:6, 2:6] = np.array([0.0, 2.0, 0.0], np.float32)
    g[7:9, 7:9, 7:9] = np.array([1.0, 0.0, 0.0], np.float32)
    g[8, 7:9, 7:9] = np.array([-1.0, 0.0, 0.0], np.float32)
    axes = np.eye(3, dtype=np.float32)
    g[9:13, 1:5, 8:12] = axes[np.indices((4, 4, 4)).sum(0) % 3]
    return g


def test_cell_signed_values_with_exact_ties_equal_jax():
    g = _tie_grid()
    n = len(g)
    jvt, jnorms = jax.jit(jdp._normalize_grid)(jnp.asarray(g))
    cells = np.argwhere(np.ones((n - 1,) * 3, bool))
    js, jc = [np.asarray(a) for a in jax.jit(jdp.cell_signed_values)(
        jvt, jnorms, jnp.asarray(cells, jnp.int32))]
    vt, norms = device_pipeline.normalize_grid(torch.from_numpy(g))
    signed, crossing = device_pipeline.cell_signed_values(
        vt, norms, torch.from_numpy(cells))
    np.testing.assert_array_equal(signed.numpy(), js)
    np.testing.assert_array_equal(crossing.numpy(), jc)
    # The tie blocks are there: constant cells have no crossing, antipodal
    # ones do.
    flat = {tuple(c): i for i, c in enumerate(cells)}
    assert not jc[flat[(3, 3, 3)]] and jc[flat[(7, 7, 7)]]


def test_first_argmax_takes_the_first_maximum():
    x = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0],
                      [0.0, 0.0, 0.0, 0.0], [-1.0, -3.0, -1.0, -2.0]])
    assert device_pipeline.first_argmax(x, 1).tolist() == [1, 0, 0, 0]
    assert device_pipeline.first_argmax(x.t(), 0).tolist() == [1, 0, 0, 0]
    np.testing.assert_array_equal(
        device_pipeline.first_argmax(x, 1).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=1)))


# ------------------------------------------------------ emission and dedup

def _emission_inputs(m=4096, seed=0):
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 31, (m, 3))
    node = (cells[:, None, :] + tables.CORNER_OFFSETS[None]).astype(
        np.float64)
    gv = node / 32 * 2.0 - 1.0
    vv = rng.randn(m, 8)
    vv[:64] = np.abs(vv[:64])                               # no crossings
    vv[64:128] = vv[64:128, :1] + rng.randn(64, 8) * 1e-7   # degenerate
    return gv, vv


@pytest.mark.parametrize("classic_table", [False, True])
def test_native_emission_and_dedup_equal_numpy_and_jax(classic_table,
                                                       monkeypatch):
    monkeypatch.setenv(classic_tables.FLAG, "1" if classic_table else "0")
    gv, vv = _emission_inputs()
    ours = contrastive.emit_triangles(gv, vv)
    assert ours.shape[0] > 1000
    np.testing.assert_array_equal(ours,
                                  contrastive.emit_triangles_numpy(gv, vv))
    np.testing.assert_array_equal(ours, jcontrastive.emit_triangles(gv, vv))
    np.testing.assert_array_equal(ours,
                                  jcontrastive.emit_triangles_numpy(gv, vv))
    verts, faces = contrastive.dedup_mesh(ours)
    assert verts.dtype == np.float32 and faces.dtype == np.int32
    assert len(verts) < 3 * len(faces)
    assert_same_mesh((verts, faces), jcontrastive.dedup_mesh(ours))
    np.testing.assert_array_equal(verts[faces], ours.astype(np.float32))


def test_contrastive_marching_cubes_equals_jax():
    vf = box_field_np(1.0)(jpipeline.sample_grid(
        20, 1.5, np.zeros(3), np.zeros(3, np.float32))).reshape(20, 20, 20, 3)
    surface = field_ops.extract_divergence(vf)
    cells = np.argwhere(surface > 0.5)
    vt = vf / np.maximum(np.linalg.norm(vf, axis=-1, keepdims=True), 1e-12)
    choice = field_ops.unify_direction(surface, vt, cells)
    comb, pair_norms = field_ops.make_comb_format(
        choice, np.linalg.norm(vf, axis=-1), cells)
    np.testing.assert_array_equal(
        contrastive.combs_to_vert_values(comb, pair_norms),
        jcontrastive.combs_to_vert_values(comb, pair_norms))
    ours = contrastive.contrastive_marching_cubes(comb, pair_norms, cells, 20)
    assert len(ours[1]) > 100
    assert_same_mesh(ours, jcontrastive.contrastive_marching_cubes(
        comb, pair_norms, cells, 20))


# ------------------------------------------------------------- pipelines

@pytest.mark.parametrize("smooth_before,smooth_after,alternative", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True)])
def test_host_pipeline_equals_jax(smooth_before, smooth_after, alternative):
    kw = dict(resolution=20, scale=1.5, centroid=np.zeros(3),
              translation=np.array([0.1, 0.0, -0.1], np.float32),
              max_batch=1000, smooth_before=smooth_before,
              smooth_after=smooth_after, alternative=alternative)
    ours = pipeline.extract_vf_mesh(box_field_np(1.0), **kw)
    assert len(ours[1]) > 100
    assert_same_mesh(ours, jpipeline.extract_vf_mesh(box_field_np(1.0),
                                                     **kw))
    for n in (8, 35, 64):
        for (t, s), (jt, js) in zip(pipeline.quadrant_translations(n, 2.2),
                                    jpipeline.quadrant_translations(n, 2.2),
                                    strict=True):
            np.testing.assert_array_equal(t, jt)
            assert s == js


VARIANTS = [dict(), dict(smooth_before=True), dict(smooth_after=True)]


@pytest.mark.parametrize("variant", range(3))
def test_extractor_equals_jax_on_one_field(variant):
    """Both extractors read one numpy field: identical meshes for the plain
    variant; the smoothed ones differ by the smoothing's last bits (see
    ``test_smooth_vf_equals_jax``), so they are held to the near-identity
    rule with the median at 1e-6."""
    jfn, tfn = shared_field(box_field_np(1.0))
    kw = VARIANTS[variant]
    offset = (np.zeros(3), np.array([0.05, 0.0, -0.05], np.float32))
    ours = device_pipeline.DeviceMeshExtractor(
        tfn, 32, device="cpu", chunk=5000, cell_bucket=700, **kw).extract(
            1.5, *offset)
    theirs = jdp.DeviceMeshExtractor(jfn, 32, chunk=8192, cell_bucket=4096,
                                     **kw).extract(1.5, *offset)
    assert len(ours[1]) > 500
    if kw:
        assert_near_identical(ours, theirs, 2 * 1.5 / 31, median=1e-6)
    else:
        assert_same_mesh(ours, theirs)


@pytest.mark.parametrize("variant", range(3))
def test_extractor_near_jax_with_own_fields(variant):
    """Each package computes the analytic box field itself."""
    kw = VARIANTS[variant]
    ours = device_pipeline.DeviceMeshExtractor(
        box_field_torch(1.0), 32, device="cpu", **kw).extract(
            1.5, np.zeros(3), np.zeros(3, np.float32))
    theirs = jdp.DeviceMeshExtractor(
        _jax_box(), 32, chunk=8192, cell_bucket=4096, **kw).extract(
            1.5, np.zeros(3), np.zeros(3, np.float32))
    assert_near_identical(ours, theirs, 2 * 1.5 / 31)


def _jax_box():
    from test_device_pipeline import analytic_box_vf_jax
    return analytic_box_vf_jax(1.0)


def test_extract_many_equals_each_extract_and_jax():
    jfn, tfn = shared_field(box_field_np(1.0))
    octants = list(pipeline.quadrant_translations(8, 1.5))
    centroid = np.array([0.02, -0.01, 0.0], np.float32)
    extractor = device_pipeline.DeviceMeshExtractor(tfn, 16, device="cpu")
    piped = extractor.extract_many(octants, centroid)
    theirs = jdp.DeviceMeshExtractor(jfn, 16, chunk=4096,
                                     cell_bucket=1024).extract_many(
        octants, centroid)
    assert sum(len(f) for _, f in piped) > 100
    for (t, s), ours, ref in zip(octants, piped, theirs, strict=True):
        assert_same_mesh(ours, extractor.extract(s, centroid, t))
        assert_same_mesh(ours, ref)


def test_empty_field_gives_an_empty_mesh():
    extractor = device_pipeline.DeviceMeshExtractor(
        lambda p: torch.ones_like(p) / np.sqrt(3.0), 16, device="cpu")
    v, f = extractor.extract(1.0, np.zeros(3), np.zeros(3, np.float32))
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_extractor_chunks_call_the_field_once_per_chunk():
    calls = []

    def fn(p):
        calls.append(p.shape[0])
        return box_field_torch(1.0)(p)

    device_pipeline.DeviceMeshExtractor(fn, 20, device="cpu",
                                        chunk=3000).extract(
        1.5, np.zeros(3), np.zeros(3, np.float32))
    assert calls == [3000] * 2 + [2000]


# --------------------------------------------------------- the model path

@pytest.fixture(scope="module")
def both_models():
    jcfg = graft._tiny_config()
    _, variables = tiny_variables(jcfg, seed=2)
    jmodel = JVectorFieldNerf(jcfg)
    jmodel.state = jmodel.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    model = VectorFieldNerf(port_config(jcfg), device="cpu")
    load_jax_variables(model, variables)
    return model, jmodel


@pytest.mark.parametrize("variant", [(False, False), (True, False),
                                     (False, True)])
def test_marching_cubes_mesh_near_jax(both_models, variant, tmp_path):
    model, jmodel = both_models
    smooth_all, smooth_after = variant
    kw = dict(resolution=32, checkpoint="7", scale=1.2, max_batch=100000,
              centroid=np.array([0.1, 0.0, -0.1], np.float32),
              smooth_after=smooth_after, smooth_all=smooth_all)
    ours = methods.marching_cubes_mesh(model, mesh_path=str(tmp_path / "t"),
                                       **kw)
    theirs = jmethods.marching_cubes_mesh(jmodel,
                                          mesh_path=str(tmp_path / "j"), **kw)
    assert_near_identical(ours, theirs, 2 * 1.2 / 31)
    for name in ("mesh-7.ply", "mesh-scaled-7.ply"):
        assert (tmp_path / "t" / name).exists()
    np.testing.assert_array_equal(
        ply.load_ply(str(tmp_path / "t" / "mesh-scaled-7.ply"))[0], ours[0])


def test_quadrant_marching_cubes_near_jax(both_models, tmp_path):
    model, jmodel = both_models
    kw = dict(resolution=32, checkpoint="latest", scale=1.2,
              max_batch=100000, centroid=np.zeros(3, np.float32),
              num_quadrants=8)
    ours = methods.quadrant_marching_cubes(
        model, mesh_path=str(tmp_path / "t"), **kw)
    theirs = jmethods.quadrant_marching_cubes(
        jmodel, mesh_path=str(tmp_path / "j"), **kw)
    assert_near_identical(ours, theirs, 1.2 / 31)
    for name in ("merged-mesh-latest.ply", "merged-mesh-scaled-latest.ply"):
        ours_file = ply.load_ply(str(tmp_path / "t" / name))
        theirs_file = jply.load_ply(str(tmp_path / "j" / name))
        assert ours_file[1].shape[1] == theirs_file[1].shape[1] == 3


# ---------------------------------------------- classic MC, TSDF, refuse

def test_classic_marching_cubes_equals_jax():
    n = 40
    coords = np.linspace(-1.2, 1.2, n)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    sdf = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.0).astype(np.float32)
    valid = np.random.RandomState(0).rand(n, n, n) > 0.05
    for kw in (dict(), dict(origin=np.full(3, -1.2), voxel_size=2.4 / 39,
                            valid=valid)):
        ours = classic.marching_cubes(sdf, 0.0, **kw)
        assert len(ours[1]) > 500
        assert_same_mesh(ours, jclassic.marching_cubes(sdf, 0.0, **kw))


def _box_views(n_images=5):
    ds = JBox(n_images=n_images, image_size=(24, 32), pixels_per_batch=96,
              half_size=1.0)
    h, w = ds.image_size
    return ds, [ds.depth_images[i].reshape(h, w) for i in range(n_images)]


@pytest.mark.parametrize("voxel,trunc", [(0.04, 0.1), (0.06, 0.15)])
def test_fuse_depth_maps_equals_jax(voxel, trunc):
    ds, depths = _box_views()
    args = (depths, list(ds.poses), [ds.intrinsics] * len(depths))
    kw = dict(voxel_size=voxel, sdf_trunc=trunc, depth_trunc=10.0)
    ours = tsdf.fuse_depth_maps(*args, **kw)
    assert len(ours[1]) > 100
    assert_same_mesh(ours, jtsdf.fuse_depth_maps(*args, **kw))


def test_render_depth_and_refuse_equal_jax():
    ds, _ = _box_views(3)
    h, w = ds.image_size
    verts, faces = ds.gt_mesh()
    verts = verts.astype(np.float32)
    for i in range(3):
        ours = renderer.render_depth(verts, faces, ds.poses[i],
                                     ds.intrinsics, h, w)
        np.testing.assert_array_equal(ours, jrenderer.render_depth(
            verts, faces, ds.poses[i], ds.intrinsics, h, w))
        assert (ours > 0).mean() > 0.5
        world_to_cam = np.linalg.inv(ds.poses[i])
        v_h = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
        cam = (v_h @ world_to_cam.T)[:, :3].astype(np.float32)
        k = ds.intrinsics
        plain = renderer._render_depth_numpy(cam, faces, k[0, 0], k[1, 1],
                                             k[0, 2], k[1, 2], h, w, 1e-4)
        np.testing.assert_allclose(ours, plain, rtol=1e-4, atol=1e-4)
    kw = dict(voxel_size=0.05, sdf_trunc=0.12, depth_trunc=10.0)
    ours = renderer.refuse_mesh(verts, faces, ds, **kw)
    assert len(ours[1]) > 100
    assert_same_mesh(ours, jrenderer.refuse_mesh(verts, faces, ds, **kw))


def test_port_scene_gt_mesh_is_jax_scene_gt_mesh():
    assert_same_mesh(SyntheticBoxDataset().gt_mesh(), JBox().gt_mesh())


# ------------------------------------------------------------------- PLY

@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trips_both_packages(binary, tmp_path):
    rng = np.random.RandomState(0)
    verts = rng.randn(50, 3).astype(np.float32)
    faces = rng.randint(0, 50, (70, 3)).astype(np.int32)
    for writer, reader in ((ply.save_ply, jply.load_ply),
                           (jply.save_ply, ply.load_ply),
                           (ply.save_ply, ply.load_ply)):
        path = str(tmp_path / "m.ply")
        writer(path, verts, faces, binary=binary)
        v, f = reader(path)
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
        assert_same_mesh(ply.load_ply(path), jply.load_ply(path))
    ply.save_ply(str(tmp_path / "p.ply"), verts, np.zeros((0, 3)), binary)
    v, f = jply.load_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(v, verts)
    assert f.shape == (0, 3)
    assert os.path.getsize(tmp_path / "p.ply") > 0


@pytest.mark.parametrize("kind", ["quads", "mixed", "extra_property"])
def test_ply_faces_other_than_triangles_load_as_jax(kind, tmp_path):
    """Quads (the one-read path), mixed polygons and faces with a second
    property (the row-by-row path) fan-triangulate as JAX's reader does."""
    rng = np.random.RandomState(1)
    verts = rng.randn(20, 3).astype(np.float32)
    rows = [rng.randint(0, 20, 4 if kind == "quads" else
                        int(rng.choice([3, 4, 5]))) for _ in range(15)]
    extra = kind == "extra_property"
    header = ["ply", "format binary_little_endian 1.0", "element vertex 20",
              "property float x", "property float y", "property float z",
              "element face 15", "property list uchar int vertex_indices"]
    if extra:
        header.append("property uchar flag")
    body = verts.tobytes()
    for r in rows:
        body += np.uint8(len(r)).tobytes() + r.astype("<i4").tobytes()
        if extra:
            body += np.uint8(7).tobytes()
    path = tmp_path / "poly.ply"
    path.write_bytes(("\n".join(header + ["end_header"]) + "\n").encode() +
                     body)
    ours, theirs = ply.load_ply(str(path)), jply.load_ply(str(path))
    assert len(ours[1]) == sum(len(r) - 2 for r in rows)
    assert_same_mesh(ours, theirs)
