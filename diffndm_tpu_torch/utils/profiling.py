"""Tracing and step timing.

- ``trace(outdir)`` records a ``torch.profiler`` trace of the enclosed
  block (CPU activity, and the card's when CUDA is available) and writes
  it as a Chrome trace (``trace.json``, for Perfetto or chrome://tracing)
  into ``outdir``; with no ``outdir`` it takes ``DIFFNDM_TRACE_DIR``,
  and without either it does nothing.
- ``annotate(name)`` names a span on the trace's timeline (and an NVTX
  range on the card).
- ``StepTimer`` keeps host wall times per step with a percentile summary;
  given a CUDA device it synchronises the card before reading the clock,
  so that a step's time includes the work it queued.
- ``PhaseProfiler`` sums the wall clock of the named phases of one guided
  sampling call (``DIFFNDM_GUIDED_PROFILE=1``, the JAX package's phase
  names) and prints them in the JAX package's format.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(outdir: Optional[str] = None):
    """Profile the enclosed block when outdir (or DIFFNDM_TRACE_DIR) is
    set; no-op otherwise.  Yields the profiler (None when off); its
    ``key_averages()`` sums the recorded ops after the block."""
    outdir = outdir or os.environ.get("DIFFNDM_TRACE_DIR")
    if not outdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(outdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named span on the profiler's timeline; an NVTX range too while
    the card is in use."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Host-side step timing with a percentile summary.  ``device``: a
    CUDA device to synchronise on entry and exit (opt-in), so that the
    time covers the card's work and not only its enqueueing."""

    def __init__(self, device=None):
        self.times = []
        self._t0 = None
        self._sync = None
        if device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda":
                self._sync = lambda: torch.cuda.synchronize(device)

    def __enter__(self):
        if self._sync is not None:
            self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(0.9 * n))],
            "min_s": ts[0],
            "max_s": ts[-1],
        }


class PhaseProfiler:
    """Wall clock per phase of a guided sampling call: ``segment`` (a run
    of reverse steps up to a guidance event), ``spsa.{probe, fetch, score,
    apply}``, ``atp.{cand, fetch, score, select}``, ``hyb.{branch, look,
    fetch, score, select}`` and ``decode``.  A ``fetch`` is the host copy
    of the decoded x0 (and of the states and masks scored beside it)
    before scoring.

    On, each phase ends by synchronising the card, so that a phase's time
    holds the work it queued (this serialises the loop: for diagnosis
    only).  Off (the default), ``phase`` is a shared null context and
    ``fetch`` the identity: no clock is read and nothing is
    synchronised."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self._open = {}
        self._sync = None
        if enabled and device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda":
                self._sync = lambda: torch.cuda.synchronize(device)

    @classmethod
    def from_env(cls, device) -> "PhaseProfiler":
        """On when ``DIFFNDM_GUIDED_PROFILE=1``."""
        return cls(os.environ.get("DIFFNDM_GUIDED_PROFILE") == "1", device)

    def phase(self, name: str):
        return self._phase(name) if self.enabled else _NULL

    @contextlib.contextmanager
    def _phase(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def begin(self, name: str) -> None:
        if self.enabled:
            self._open[name] = time.perf_counter()

    def end(self, name: str) -> None:
        if self.enabled:
            if self._sync is not None:
                self._sync()
            self.total[name] += time.perf_counter() - self._open.pop(name)
            self.count[name] += 1

    def fetch(self, tensor):
        """The tensor on the host while profiling, else itself."""
        return tensor.cpu() if self.enabled else tensor

    def report(self) -> str:
        lines = ["guided-phase profile (s, calls):"]
        for k in sorted(self.total, key=self.total.get, reverse=True):
            lines.append("  %-16s %8.3f  x%d" % (k, self.total[k],
                                                 self.count[k]))
        lines.append("  %-16s %8.3f" % ("TOTAL", sum(self.total.values())))
        return "\n".join(lines)


_NULL = contextlib.nullcontext()
OFF = PhaseProfiler()
