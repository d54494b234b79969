"""The program's spans in a traced sub-window (``trace.Summary``), put
down to the layers they belong to.

``GROUPS`` is frozen here, apart from the program: a span renamed there
drops out of its group, and a metric of a group with no span in the
trace reads nothing (None) instead of moving to another layer.  A trace
of a program without these spans reads None everywhere.

- ``idle_in(run, group)``: the share of the traced sub-window with the
  card idle while the host was in ``group``.  Each idle gap goes to the
  program span open at the gap's end that began last, on any host
  thread: during ``backward`` autograd's own thread runs the kernels'
  backward wrappers while the loop's thread sits in ``backward``.  Only
  whole spans count (``Summary.host`` holds no other); the profiler's
  mirrors of the ranges on the device timeline (``gpu_user_annotation``)
  are not host events and never count.
- ``launches_per_span(run, name)``: runtime launch calls inside whole
  spans ``name``, per span.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List, Optional, Tuple

from benchmark.trace import LAUNCH

GROUPS = {
    "sampler.step": "sampler",
    "decode": "sampler",
    "denoiser.forward": "denoiser",
    "backward": "autograd",
    "optimizer": "optimizer",
    "facade.sample_given_pocket": "other",
    "facade.result_to_molecules": "other",
    "forward": "other",
    "all_reduce": "other",
    "readback": "other",
    "oracle.score": "other",
    **{f"spsa.{p}": "other" for p in ("probe", "fetch", "score", "apply")},
    **{f"atp.{p}": "other" for p in ("cand", "fetch", "score", "select")},
    **{f"hyb.{p}": "other"
       for p in ("branch", "look", "fetch", "score", "select")},
}
KERNELS = "kernels."     # every span of the kernel wrappers


def group_of(name: str) -> Optional[str]:
    """The group of a program span, None for any other host event."""
    if name.startswith(KERNELS):
        return "kernels"
    return GROUPS.get(name)


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


def idle_gaps(summary) -> List[Tuple[float, float]]:
    """The traced sub-window's stretches with nothing on the card (trace
    microseconds)."""
    edges = [summary.t0] + [x for ab in summary.busy for x in ab] \
        + [summary.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_in(run, group: str) -> Optional[float]:
    """Idle share of the traced sub-window, in %, whose gaps end inside
    a span of ``group`` (the latest-begun program span open there)."""
    s = run.trace
    if s is None or s.window_s <= 0:
        return None
    spans = sorted((e for e in s.host if group_of(e["name"]) is not None),
                   key=lambda e: e["ts"])
    if not any(group_of(e["name"]) == group for e in spans):
        return None
    starts = [e["ts"] for e in spans]
    idle = 0.0
    for a, b in idle_gaps(s):
        i = bisect_right(starts, b) - 1
        while i >= 0 and _end(spans[i]) < b:
            i -= 1
        if i >= 0 and group_of(spans[i]["name"]) == group:
            idle += b - a
    return 100.0 * idle * 1e-6 / s.window_s


def launches_per_span(run, name: str) -> Optional[float]:
    """Runtime kernel and graph launch calls inside whole spans ``name``,
    per span."""
    s = run.trace
    if s is None:
        return None
    spans = [e for e in s.host if e["name"] == name]
    if not spans:
        return None
    at = sorted(e["ts"] for e in s.runtime if LAUNCH.match(e["name"]))
    inside = sum(bisect_right(at, _end(e)) - bisect_left(at, e["ts"])
                 for e in spans)
    return inside / len(spans)
