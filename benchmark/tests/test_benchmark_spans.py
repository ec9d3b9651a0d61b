"""The span readers (``benchmark/spans.py`` and the ``metrics/`` that read
the program's spans) on a synthetic traced window: idle intervals split at
span boundaries, the innermost span wins and is filed under its root, the
feed worker's spans stay out of the idle split, None without spans or
without a base that fits, and the three training idle shares within the
device's idle share."""

import pytest

from benchmark import harness, spans
from benchmark.harness import HERE
from benchmark.trace import Traced

# A base as Kineto sets it: unix time rounded down to its boundary.
STEP_NS = spans.TRIMONTH_S * 1_000_000_000
BASE = 1_790_857_031_123_456_789 // STEP_NS * STEP_NS
MAIN, WORKER = 101, 202
TRAIN_IDLE = ("idle_feed_wait.train", "idle_step_enqueue.train",
              "idle_epoch_edge.train")
NEW = TRAIN_IDLE + ("host_step_ms.train", "feed_ms.train",
                    "idle_chunk_enqueue.render", "host_chunk_ms.render")


def traced(busy_us, window_s=1e-3, unit="step", units=2):
    """A window whose device is busy over ``busy_us`` (µs after BASE)."""
    return Traced([("kernel", "k", a, b - a) for a, b in busy_us], window_s,
                  unit, units, {})


def span(name, a_us, b_us, tid=MAIN, base=BASE):
    return (name, tid, base + int(a_us * 1e3), base + int(b_us * 1e3))


def read(name, t, monkeypatch, recorded):
    monkeypatch.setattr(spans, "program_spans", lambda: recorded)
    return harness.load_module(HERE / "metrics" / f"{name}.py").read(t)


def test_idle_splits_at_span_boundaries():
    t = traced([(0, 10), (30, 40)])
    recorded = [span("train.feed_wait", 5, 20), span("train.step", 20, 40)]
    idle = spans.idle_by_span(t, recorded)
    assert idle[("train.feed_wait", "train.feed_wait")] == pytest.approx(
        10e-6)
    assert idle[("train.step", "train.step")] == pytest.approx(10e-6)
    assert idle[(None, None)] == pytest.approx(0.0, abs=1e-12)


def test_the_innermost_span_wins_under_its_root():
    t = traced([(0, 10), (30, 40), (50, 60)])
    recorded = [span("train.step", 0, 100),
                span("train.step.forward", 15, 25),
                span("render.coarse", 18, 22),
                span("train.step.backward", 45, 48)]
    idle = spans.idle_by_span(t, recorded)
    assert idle == pytest.approx({
        ("train.step", "train.step"): 17e-6,
        ("train.step", "train.step.forward"): 6e-6,
        ("train.step", "render.coarse"): 4e-6,
        ("train.step", "train.step.backward"): 3e-6,
        (None, None): 0.0}, abs=1e-12)


def test_worker_spans_stay_out_of_the_idle_split():
    t = traced([(0, 10), (30, 40)])
    recorded = [span("train.step", 0, 12), span("train.step", 28, 40),
                span("feed.pack", 0, 40, tid=WORKER),
                span("feed.copy", 12, 28, tid=WORKER)]
    idle = spans.idle_by_span(t, recorded)
    assert idle[("train.step", "train.step")] == pytest.approx(4e-6)
    assert idle[(None, None)] == pytest.approx(16e-6)
    assert not any(root and root.startswith("feed.") for root, _ in idle)


def test_absolute_timestamps_take_base_zero():
    t = traced([(x + BASE / 1e3, y + BASE / 1e3) for x, y in
                [(0, 10), (30, 40)]])
    recorded = [span("train.step", 0, 40)]
    assert spans.trace_base_ns(t, recorded) == 0
    idle = spans.idle_by_span(t, recorded)
    # Microseconds since 1970 in a double: a quarter-µs apart.
    assert idle[("train.step", "train.step")] == pytest.approx(20e-6,
                                                              abs=1e-6)


def test_none_without_spans_or_a_base_that_fits(monkeypatch):
    t = traced([(0, 10), (30, 40)])
    assert spans.idle_by_span(t, []) is None
    far = [span("train.step", 2e6, 2e6 + 40)]       # 2 s after the records
    assert spans.trace_base_ns(t, far) is None
    assert spans.idle_by_span(t, far) is None
    no_main = [span("feed.pack", 0, 40, tid=WORKER)]
    assert spans.idle_by_span(t, no_main) is None
    render = traced([(0, 10), (30, 40)], unit="chunk")
    for name in NEW:
        for window in (t, render):
            assert read(name, window, monkeypatch, []) is None
            assert read(name, window, monkeypatch, far) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from vf_nerf_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spans.program_spans() == []
    t = traced([(0, 10), (30, 40)])
    for name in NEW:
        assert harness.load_module(HERE / "metrics" / f"{name}.py").read(
            t) is None


def epoch_window():
    """Two steps with a feed wait between them, an epoch edge and a gap
    outside every span, in a 200 µs window."""
    t = traced([(10, 20), (40, 60), (90, 100), (150, 160)], window_s=200e-6)
    recorded = [span("train.epoch_start", 0, 15),
                span("train.feed_wait", 15, 25),
                span("train.step", 25, 70),
                span("train.step.forward", 28, 35),
                span("train.feed_wait", 70, 95),
                span("train.step", 95, 120),
                span("train.epoch_read", 125, 140),
                span("feed.assemble", 0, 5, tid=WORKER),
                span("feed.pack", 5, 9, tid=WORKER),
                span("feed.copy", 9, 10, tid=WORKER),
                span("feed.assemble", 60, 62, tid=WORKER),
                span("feed.pack", 62, 66, tid=WORKER),
                span("feed.copy", 66, 70, tid=WORKER)]
    return t, recorded


def test_train_readers(monkeypatch):
    t, recorded = epoch_window()
    got = {name: read(name, t, monkeypatch, recorded) for name in NEW}
    # Gaps: 20-40 (feed wait 20-25, step 25-40), 60-90 (step 60-70, feed
    # wait 70-90), 100-150 (step 100-120, outside 120-125 and 140-150,
    # epoch read 125-140).
    assert got["idle_feed_wait.train"] == pytest.approx(100 * 25 / 200)
    assert got["idle_step_enqueue.train"] == pytest.approx(100 * 45 / 200)
    assert got["idle_epoch_edge.train"] == pytest.approx(100 * 15 / 200)
    assert got["host_step_ms.train"] == pytest.approx((45 + 25) / 2 / 1e3)
    assert got["feed_ms.train"] == pytest.approx((10 + 10) / 2 / 1e3)
    assert got["idle_chunk_enqueue.render"] is None
    assert got["host_chunk_ms.render"] is None


@pytest.mark.parametrize("shift", [0, 3, 17])
def test_train_idle_shares_within_device_idle(monkeypatch, shift):
    t, recorded = epoch_window()
    moved = [(n, tid, a + shift * 1000, b + shift * 1000)
             for n, tid, a, b in recorded]
    total = sum(read(name, t, monkeypatch, moved) for name in TRAIN_IDLE)
    device_idle = harness.load_module(
        HERE / "metrics" / "device_idle.train.py").read(t)
    assert 0 < total <= device_idle + 1e-9


def test_render_readers(monkeypatch):
    t = traced([(0, 10), (30, 40), (70, 80)], window_s=100e-6,
               unit="chunk")
    recorded = [span("render.chunk", 0, 35), span("render.fold", 5, 25),
                span("render.chunk", 35, 50)]
    assert read("idle_chunk_enqueue.render", t, monkeypatch,
                recorded) == pytest.approx(100 * (20 + 10) / 100)
    assert read("host_chunk_ms.render", t, monkeypatch,
                recorded) == pytest.approx((35 + 15) / 2 / 1e3)
    for name in NEW[:5]:
        assert read(name, t, monkeypatch, recorded) is None
