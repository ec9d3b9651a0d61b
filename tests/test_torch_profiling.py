"""The port's span recorder (``vf_nerf_torch/utils/profiling.py``) on the
CPU: spans only inside a profiler session, the shared no-op context outside
one, nesting and thread ids, the buffer cleared as a session begins, the
spans on the Chrome trace's clock, and the spans a runner epoch and an eval
render record."""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vf_nerf_torch.config import parse_config
from vf_nerf_torch.utils import profiling

CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")


def session():
    return profile(activities=[ProfilerActivity.CPU])


def named(recorded, name):
    return [s for s in recorded if s[0] == name]


def inside(inner, outer):
    return outer[2] <= inner[2] <= inner[3] <= outer[3]


def test_no_session_records_nothing_through_one_shared_context():
    before = profiling.spans()
    off = profiling.span("a")
    assert off is profiling.span("b")
    with off:
        with profiling.span("c"):
            torch.ones(3).sum()
    assert profiling.spans() == before
    with session():
        assert profiling.span("a") is not off
    assert not named(profiling.spans(), "c")


def test_spans_nest_and_keep_their_threads():
    def worker():
        with profiling.span("worker"):
            torch.ones(3).sum()

    with session():
        with profiling.span("outer"):
            with profiling.span("inner"):
                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=30)
    assert not thread.is_alive()
    recorded = profiling.spans()
    (outer,), (inner,), (work,) = (named(recorded, n)
                                   for n in ("outer", "inner", "worker"))
    assert inside(inner, outer)
    assert outer[1] == inner[1] == threading.get_native_id()
    assert work[1] != outer[1]


def test_a_session_begins_with_an_empty_buffer():
    with session():
        with profiling.span("first"):
            pass
    assert [s[0] for s in profiling.spans()] == ["first"]
    with session():
        assert profiling.spans() == []
        with profiling.span("second"):
            pass
    assert [s[0] for s in profiling.spans()] == ["second"]


def test_threads_record_every_span():
    """Many more threads than cores, switching often: no span is lost."""
    n_threads, per = 32, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with session():
            threads = [threading.Thread(
                target=lambda: [profiling.span("s").__enter__().__exit__()
                                for _ in range(per)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recorded = profiling.spans()
    assert len(recorded) == n_threads * per
    assert len({s[1] for s in recorded}) > 1


def test_trace_writes_the_spans_on_the_trace_clock(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with record_function("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (outer,) = [e for e in events if e.get("cat") == "program_span"]
    (inner,) = [e for e in events if e.get("name") == "inner"
                and e.get("cat") == "user_annotation"]
    assert outer["name"] == "outer" and outer["ph"] == "X"
    assert (outer["pid"], outer["tid"]) == (inner["pid"], inner["tid"])
    # Within 1 ms (the trace's µs) at both ends.
    assert inner["ts"] >= outer["ts"] - 1e3
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e3


def small_runner(tmp_path):
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner
    cfg = parse_config(scene="s", config_path=CONF, gpu="cpu",
                       timestamp="t", offline=True)
    cfg.dataset_config.dataset_name = "synthetic"
    cfg.dataset_config.pixels_per_batch = 32
    cfg.exps_folder = str(tmp_path / "exps")
    net = cfg.vf_nerf_config
    net.vf_net_config.dimensions = [48, 48]
    net.vf_net_config.skip_connection_in = [1]
    net.rendering_net_config.dimensions = [16]
    rs = net.ray_sampler_config
    rs.n_samples, rs.n_importance, rs.max_samples = 8, 4, 8
    return VectorFieldNerfRunner(cfg)


def test_runner_epochs_record_their_spans(tmp_path):
    runner = small_runner(tmp_path)
    runner.train_epoch(0)            # the step and the caches built
    with session():
        for epoch in (1, 2):
            runner.train_epoch(epoch)
    recorded = profiling.spans()
    main = threading.get_native_id()
    steps = named(recorded, "train.step")
    assert len(steps) == 2 * len(runner.dataset)
    assert {s[1] for s in steps} == {main}
    for part in ("draw", "forward", "backward", "optimizer"):
        nested = named(recorded, f"train.step.{part}")
        assert len(nested) == len(steps)
        assert all(inside(n, s) for n, s in zip(nested, steps))
    assert len(named(recorded, "train.epoch_start")) == 2
    assert len(named(recorded, "train.epoch_read")) == 2
    # A wait before each step, and one for the end of each epoch.
    order = sorted(named(recorded, "train.feed_wait") + steps,
                   key=lambda s: s[2])
    assert all(a[3] <= b[2] for a, b in zip(order, order[1:]))
    assert "".join("S" if s[0] == "train.step" else "W"
                   for s in order) == ("WS" * len(runner.dataset) + "W") * 2
    feed = [s for s in recorded if s[0].startswith("feed.")]
    assert len(named(feed, "feed.pack")) == len(steps)
    assert len(named(feed, "feed.copy")) == len(steps)
    assert len(named(feed, "feed.assemble")) == len(steps) + 2
    assert main not in {s[1] for s in feed}


def test_render_image_records_a_span_per_chunk(tmp_path):
    runner = small_runner(tmp_path)
    model, ds = runner.model, runner.dataset
    model.eval()
    h, w = ds.image_size
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h)),
                  -1).reshape(-1, 2)[:64].astype(np.float32)
    with session():
        rgb, _ = model.render_image(uv, ds.poses[0], ds.intrinsics, 0,
                                    split_size=32)
    assert rgb.shape == (64, 3)
    recorded = profiling.spans()
    chunks = named(recorded, "render.chunk")
    assert len(chunks) == 2
    for stage in ("fold", "coarse", "sample", "fine", "march"):
        inner = named(recorded, f"render.{stage}")
        assert len(inner) == 2
        assert all(inside(i, c) for i, c in zip(inner, chunks))


def test_joint_epochs_record_their_spans(tmp_path):
    """A joint epoch with a supervision block and one without: the step's
    and the block's spans nested as named, on the main thread, and none
    outside a profiler session."""
    from test_torch_joint_reference import small_joint_runner
    runner = small_joint_runner(tmp_path)[0]
    before = profiling.spans()
    runner.train_epoch(0)            # a block, outside a session
    assert profiling.spans() == before
    with session():
        runner.train_epoch(10)       # a block
        runner.train_epoch(11)
    recorded = profiling.spans()
    main = threading.get_native_id()
    assert {s[1] for s in recorded} == {main}
    steps = named(recorded, "joint.step")
    assert len(steps) == 2 * len(runner.dataset)
    for part in ("forward", "backward", "optimizer"):
        nested = named(recorded, f"joint.step.{part}")
        assert len(nested) == len(steps)
        assert all(inside(n, s) for n, s in zip(nested, steps))
    forward = named(recorded, "joint.step.forward")
    for stage in ("coarse", "sample", "fine", "march"):
        inner = named(recorded, f"render.{stage}")
        assert len(inner) == len(steps)
        assert all(inside(i, f) for i, f in zip(inner, forward))
    (block,) = named(recorded, "joint.supervise")
    assert block[3] <= steps[0][2]
    n_sup = runner.config.train_config.supervision_epochs
    for part, count in (("bases", 1), ("batch", 1), ("step", n_sup)):
        nested = named(recorded, f"joint.supervise.{part}")
        assert len(nested) == count
        assert all(inside(n, block) for n in nested)
    reads = named(recorded, "joint.epoch_read")
    assert len(reads) == 2
    assert reads[0][2] >= steps[len(runner.dataset) - 1][3]
    assert reads[1][2] >= steps[-1][3]
    assert len(named(recorded, "joint.feed_wait")) == \
        2 * (len(runner.dataset) + 1)
