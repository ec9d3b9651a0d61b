"""The ``joint.refine.office`` cell on the CPU: the narrowed cell through
the whole run (correct, and its metrics), planted faults that come out not
correct, the seven joint readers on a synthetic traced window, the work
count against the hand count, the pose perturbation's recipe, and the
reference's imports."""

import functools
import json
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from benchmark import harness, spans
from benchmark.harness import HERE, ROOT
from benchmark.kinds.joint import perturbed_pose7
from benchmark.tests.conftest import cpu_run, small_cell
from benchmark.tools.readings_joint import planted
from benchmark.trace import Traced

CELL = "joint.refine.office"
STEP_NS = spans.TRIMONTH_S * 1_000_000_000
BASE = 1_790_857_031_123_456_789 // STEP_NS * STEP_NS
MAIN, WORKER = 101, 202
READERS = ("mfu.joint", "kernels_per_step.joint", "device_idle.joint",
           "idle_step_enqueue.joint", "host_step_ms.joint",
           "idle_supervise.joint", "mlp_backward_roofline.joint",
           "fused_mlp_roofline.joint", "idle_feed_wait.joint",
           "idle_epoch_edge.joint")
SPAN_READERS = ("idle_step_enqueue.joint", "host_step_ms.joint",
                "idle_supervise.joint", "idle_feed_wait.joint",
                "idle_epoch_edge.joint")


def joint_cell():
    cell = small_cell(CELL)
    cell.traffic["pixels_per_batch"] = 64     # 16 rays from each view
    return cell


def test_the_narrowed_cell_is_correct():
    cell = joint_cell()
    result = harness.run_cell(cpu_run(cell))
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert set(result["checks"]) == set(cell.limits)
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


@pytest.mark.parametrize("fault", ["half_batch", "pose_grad_zeroed"])
def test_fault_is_not_correct(fault):
    cell = joint_cell()
    with planted(fault):
        result = harness.run_cell(cpu_run(cell))
    assert result["correct"] is False
    assert [k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("fault", ["none", "half_batch", "pose_grad_zeroed"])
def test_the_cell_through_step_graphs(monkeypatch, fault):
    """The joint steps through ``StepGraph`` (``EagerGraph`` standing in
    for the CUDA graph, as on the card after the first step): the checked
    steps read from the replayed steps' records, correct without a fault
    and not correct with one planted (captured into the graph)."""
    from vf_nerf_torch.train import joint_runner as jr
    own_init = jr.JointOptimizationRunner.__init__

    @functools.wraps(own_init)
    def init(self, *a, **k):
        own_init(self, *a, **k)
        self.cuda_graphs, self.graph_factory = True, jr.EagerGraph
    monkeypatch.setattr(jr.JointOptimizationRunner, "__init__", init)
    cell = joint_cell()
    with planted(fault):
        result = harness.run_cell(cpu_run(cell))
    assert result["correct"] is (fault == "none"), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


# ------------------------------------------------------------- the readers
def span(name, a_us, b_us, tid=MAIN):
    return (name, tid, BASE + int(a_us * 1e3), BASE + int(b_us * 1e3))


def window(unit="joint_step"):
    """Two joint steps and a supervision block in a 200 µs window: a GEMM,
    a fused-MLP launch and a copy."""
    t = Traced([("kernel", "cutlass_80_simt_sgemm_128x256", 10, 10),
                ("kernel", "fused_mlp_kernel<true>(", 40, 20),
                ("kernel", "sm80_xmma_gemm_f32f32", 90, 10),
                ("gpu_memcpy", "Memcpy DtoH", 150, 10)],
               200e-6, unit, 2,
               {"step": 1e9, "mlp_forward": 4e8, "mlp_backward": 6e8})
    recorded = [span("joint.supervise", 0, 30),
                span("joint.supervise.bases", 0, 12),
                span("joint.supervise.step", 12, 30),
                span("joint.feed_wait", 30, 35),
                span("joint.step", 35, 70),
                span("joint.step.forward", 36, 50),
                span("render.coarse", 37, 45),
                span("joint.step", 70, 120),
                span("joint.epoch_read", 125, 165),
                span("other", 0, 1, tid=WORKER)]
    return t, recorded


def read(name, t, monkeypatch, recorded):
    monkeypatch.setattr(spans, "program_spans", lambda: recorded)
    return harness.load_module(HERE / "metrics" / f"{name}.py").read(t)


def test_readers_on_a_traced_window(monkeypatch):
    t, recorded = window()
    got = {n: read(n, t, monkeypatch, recorded) for n in READERS}
    # Gaps: 20-40 (supervise 20-30, feed wait 30-35, step 35-40), 60-90
    # (step), 100-150 (step 100-120, outside 120-125, read 125-150).
    assert got["idle_supervise.joint"] == pytest.approx(100 * 10 / 200)
    assert got["idle_step_enqueue.joint"] == pytest.approx(100 * 55 / 200)
    assert got["host_step_ms.joint"] == pytest.approx((35 + 50) / 2 / 1e3)
    assert got["device_idle.joint"] == pytest.approx(100 * 150 / 200)
    assert got["kernels_per_step.joint"] == 1.5
    assert got["mfu.joint"] == pytest.approx(100 * 2e9 / (200e-6 * 165e12))
    assert got["mlp_backward_roofline.joint"] == pytest.approx(
        100 * 1.2e9 / (20e-6 * 165e12))
    assert got["fused_mlp_roofline.joint"] == pytest.approx(
        100 * 8e8 / (20e-6 * 165e12))
    assert got["idle_feed_wait.joint"] == pytest.approx(100 * 5 / 200)
    assert got["idle_epoch_edge.joint"] == pytest.approx(100 * 25 / 200)
    for name in SPAN_READERS:
        assert read(name, t, monkeypatch, []) is None
        assert read(name, t, monkeypatch,
                    [s for s in recorded if s[0] != "joint.step"]) is None
    other = window(unit="step")[0]
    for name in READERS:
        assert read(name, other, monkeypatch, recorded) is None


# --------------------------------------------------------------- the work
@pytest.mark.parametrize("rgb", [0.0, 2.0])
def test_work_of_a_joint_step(rgb):
    cell = harness.find_cell(CELL)
    assert cell.conf["supervised_loss_weights"]["rgb"] == 0.0
    cell.conf["supervised_loss_weights"]["rgb"] = rgb
    work = cell.hooks.work(cell.conf, cell.traffic)
    rays, vf, colour = 1008, 525_056, 271_360
    # Every pass with its gradient: the count of a loss that weighs rgb.
    step = 2 * (rays * 100 * vf + 3 * rays * 200 * (vf + colour))
    assert step / 1e9 == pytest.approx(1069.1960832, rel=1e-12)
    # At rgb 0 the colour pass's backward is not needed: 4 x its forward
    # less.
    needed = step - (0 if rgb else 4 * rays * 200 * colour)
    assert needed / 1e9 == pytest.approx(
        1069.1960832 if rgb else 850.3713792, rel=1e-12)
    # A block: the bases' field at 4,080 points, two batches snapped, two
    # supervised steps of 4,080 surface and 4,080 off-surface points, over
    # the 240 joint steps between blocks.
    block = 2 * (4080 * 3 + 3 * 2 * 2 * 4080) * vf
    assert block / 240 / 1e9 == pytest.approx(0.26777856, rel=1e-12)
    assert work["step"] == pytest.approx(needed + block / 240, rel=1e-15)
    assert work["mlp_forward"] == pytest.approx(
        2 * (rays * 100 * vf + rays * 200 * (vf + colour)) +
        2 * (4080 * 3 + 2 * 2 * 4080) * vf / 240, rel=1e-15)
    assert work["mlp_backward"] == pytest.approx(
        4 * rays * 200 * (vf + (colour if rgb else 0)) +
        4 * 2 * 2 * 4080 * vf / 240, rel=1e-15)


def test_the_poses_are_perturbed_by_the_recipe():
    poses = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    poses[:, :3, :3] = Rotation.random(24, random_state=3).as_matrix()
    poses[:, :3, 3] = np.random.RandomState(4).randn(24, 3)
    pose7 = perturbed_pose7(poses, 2**31 + 5, 1.5, 0.02)
    rot = Rotation.from_quat(np.concatenate([pose7[:, 1:4], pose7[:, :1]],
                                            1))
    rel = Rotation.from_matrix(poses[:, :3, :3]).inv() * rot
    np.testing.assert_allclose(np.rad2deg(rel.magnitude()), 1.5, atol=1e-3)
    np.testing.assert_allclose(
        np.linalg.norm(pose7[:, 4:] - poses[:, :3, 3], axis=1), 0.02,
        rtol=1e-4)
    again = perturbed_pose7(poses, 2**31 + 5, 1.5, 0.02)
    assert np.array_equal(pose7, again)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.plain.joint; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('vf_nerf_torch', 'vf_nerf_tpu', 'jax', 'flax')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_the_cell_in_the_benchmark():
    spec = harness.bench_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[CELL]["chips"] == 1 and cells[CELL]["config"] == \
        "vf_nerf_joint"
    assert all(w["chips"] == 1 for w in cells.values())
    assert {m["name"] for m in harness.per_layer_of(spec, CELL)} == \
        set(READERS)


def test_the_gate_is_held_to_the_references_own():
    import torch
    from benchmark.plain.joint import gate_choice, gate_of
    miss = torch.tensor([1.0, 0.9, 0.52, 0.2, 0.8, 0.7])
    cos = torch.tensor([0.0, 0.1, 0.0, 0.0, 0.52, 0.9])
    own = gate_of(miss, cos)
    assert own.tolist() == [True, True, True, False, False, False]
    assert gate_choice(miss, cos, None)[1:] == (0, 3)
    assert gate_choice(miss, cos, own)[1:] == (0, 3)
    # Flips within reach of a threshold (a miss of 0.52 against 0.5, a
    # cosine of 0.52) do not count; flips far from both do.
    near = own.clone()
    near[2], near[4] = False, True
    assert gate_choice(miss, cos, near)[1:] == (0, 4)
    far = own.clone()
    far[1], far[3], far[5] = False, True, True
    taken, off, pairs = gate_choice(miss, cos, far)
    assert taken is far and (off, pairs) == (3, 5)
    assert gate_choice(miss, cos, own[:4])[1:] == (6, 6)
