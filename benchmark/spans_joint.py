"""The joint stage's idle time by host span: ``benchmark/spans.py``'s split,
on the thread that holds the ``joint.step`` spans (``spans.py`` finds the
main thread by the training step's and the eval chunk's spans, which the
joint stage does not record). None without aligned spans."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from benchmark import spans

MAIN_SPAN = "joint.step"


def idle_by_span(t, recorded: Optional[List[spans.Span]] = None
                 ) -> Optional[Dict[Tuple[Optional[str], Optional[str]],
                                    float]]:
    """Idle seconds of the window by (root, innermost) span of the thread
    that holds the most ``joint.step`` spans."""
    recorded = spans.program_spans() if recorded is None else recorded
    base = spans.trace_base_ns(t, recorded)
    threads = collections.Counter(s[1] for s in recorded
                                  if s[0] == MAIN_SPAN)
    if base is None or not threads:
        return None
    main = threads.most_common(1)[0][0]
    mine = [(name, (a - base) / 1e3, (b - base) / 1e3)
            for name, tid, a, b in recorded if tid == main]
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(t.intervals,
                                                  t.intervals[1:])]
    idle = spans.attribute(gaps, spans.segments(mine))
    return {k: v / 1e6 for k, v in idle.items()}


def idle_share(t, roots: Tuple[str, ...]) -> Optional[float]:
    """The share (%) of the window's wall seconds that the device sat idle
    under spans whose root is one of ``roots``."""
    idle = idle_by_span(t)
    if idle is None or t.window_s <= 0.0:
        return None
    return 100.0 * sum(s for (root, _), s in idle.items()
                       if root in roots) / t.window_s
