"""The program's host spans on the traced window's clock, for the readers of
``metrics/`` that put the device's idle time down to what the host did.

The program records a span (``vf_nerf_torch/utils/profiling.py``) as
``(name, native thread id, start ns, end ns)`` on ``time.time_ns()`` while
a profiler session is active. ``trace.profile`` keeps each device record's
``ts`` in µs after the Chrome trace's ``baseTimeNanoseconds`` and drops that
base, so it is rebuilt here: Kineto sets it to unix time rounded down to a
~three-month boundary (``TRIMONTH_S``), and some builds write absolute
``ts`` (base 0). The base kept is the one under which every device record
lies within the spans' extent, give or take ``SLACK_NS``; where none fits,
or the program recorded no spans (a program older than them), the readers
get None.

An idle interval is a gap between the window's merged device intervals.
Each part of it goes to the innermost span open on the main thread at that
instant (the thread holding ``train.step`` or ``render.chunk`` spans), and
is filed under that span's outermost enclosing span, its root; a part in no
span is filed under (None, None).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Tuple

TRIMONTH_S = 7889238
SLACK_NS = 500_000_000
MAIN_SPANS = ("train.step", "render.chunk")

Span = Tuple[str, int, int, int]        # name, thread id, start ns, end ns


def program_spans() -> List[Span]:
    """The spans the program recorded in the last profiler session; none
    from a program without the recorder."""
    from vf_nerf_torch.utils import profiling
    return list(getattr(profiling, "spans", list)())


def trace_base_ns(t, recorded: List[Span]) -> Optional[int]:
    """The base (ns) of the device records' ``ts``, or None where neither
    Kineto's base nor 0 puts every record within the spans' extent."""
    if not recorded or not t.records:
        return None
    first = min(s[2] for s in recorded)
    last = max(s[3] for s in recorded)
    lo = min(r[2] for r in t.records)
    hi = max(r[2] + r[3] for r in t.records)
    step = TRIMONTH_S * 1_000_000_000
    for base in sorted({first // step * step, last // step * step}) + [0]:
        if (first - SLACK_NS - base) / 1e3 <= lo and \
                hi <= (last + SLACK_NS - base) / 1e3:
            return base
    return None


def main_thread(recorded: List[Span]) -> Optional[int]:
    """The thread that holds the most ``MAIN_SPANS``."""
    counts = collections.Counter(s[1] for s in recorded
                                 if s[0] in MAIN_SPANS)
    return counts.most_common(1)[0][0] if counts else None


def segments(spans: List[Tuple[str, float, float]]
             ) -> List[Tuple[float, float, str, str]]:
    """Nested spans of one thread, ``(name, start, end)``, as disjoint
    ``(start, end, root, innermost)`` pieces in time order."""
    events = []
    for i, (_, a, b) in enumerate(spans):
        events.append((a, 1, -b, i))    # at one instant the outer opens first
        events.append((b, 0, -a, i))    # ends before starts, inner first
    events.sort()
    out, stack, prev = [], [], None
    for when, opens, _, i in events:
        if stack and when > prev:
            out.append((prev, when, spans[stack[0]][0], spans[stack[-1]][0]))
        prev = when
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def attribute(gaps: Iterable[Tuple[float, float]],
              pieces: List[Tuple[float, float, str, str]]
              ) -> Dict[Tuple[Optional[str], Optional[str]], float]:
    """The length of sorted ``gaps`` under each (root, innermost) of sorted
    disjoint ``pieces``; what no piece covers under (None, None)."""
    out: Dict[Tuple[Optional[str], Optional[str]], float] = \
        collections.defaultdict(float)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, root, inner = pieces[k]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[(root, inner)] += overlap
                covered += overlap
            k += 1
        out[(None, None)] += (b - a) - covered
    return dict(out)


def idle_by_span(t, recorded: Optional[List[Span]] = None
                 ) -> Optional[Dict[Tuple[Optional[str], Optional[str]],
                                    float]]:
    """Idle seconds of the window by (root, innermost) span of the main
    thread, or None without aligned spans."""
    recorded = program_spans() if recorded is None else recorded
    base = trace_base_ns(t, recorded)
    main = main_thread(recorded)
    if base is None or main is None:
        return None
    mine = [(name, (a - base) / 1e3, (b - base) / 1e3)
            for name, tid, a, b in recorded if tid == main]
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(t.intervals,
                                                  t.intervals[1:])]
    idle = attribute(gaps, segments(mine))
    return {k: v / 1e6 for k, v in idle.items()}


def idle_share(t, roots: Tuple[str, ...]) -> Optional[float]:
    """The share (%) of the window's wall seconds that the device sat idle
    under spans whose root is one of ``roots``."""
    idle = idle_by_span(t)
    if idle is None or t.window_s <= 0.0:
        return None
    return 100.0 * sum(s for (root, _), s in idle.items()
                       if root in roots) / t.window_s


def ms_per(t, names: Tuple[str, ...], per: str) -> Optional[float]:
    """Milliseconds inside spans named in ``names``, over the number of
    ``per`` spans; None without aligned spans or without a ``per`` span."""
    recorded = program_spans()
    if trace_base_ns(t, recorded) is None:
        return None
    count = sum(1 for s in recorded if s[0] == per)
    if not count:
        return None
    return sum(b - a for name, _, a, b in recorded
               if name in names) / 1e6 / count
