"""Tracing.

- ``trace(outdir)`` records a ``torch.profiler`` trace of the enclosed
  block (CPU activity, and the card's when CUDA is available) and writes
  it as a Chrome trace (``trace.json``, for Perfetto or chrome://tracing)
  into ``outdir``; with no ``outdir`` it takes ``DIFFNDM_TRACE_DIR``,
  and without either it does nothing.
- ``annotate(name)`` names a span on the profiler's timeline: a
  ``record_function`` range, in the Chrome trace a ``user_annotation``
  event on the clock of the card's kernels.  With no profiler recording
  it costs one flag check and returns a shared null context.
- ``PhaseProfiler`` names the phases of one guided sampling call as
  spans, and with ``DIFFNDM_GUIDED_PROFILE=1`` also sums their wall clock
  and prints them in the JAX package's format.

The port's spans, by layer: ``facade.sample_given_pocket``,
``facade.result_to_molecules`` (``model.py``); ``sampler.step`` (one per
reverse step, with its guidance events and frame tap) and ``decode``
(``diffusion/sampler.py``, ``inpaint.py``, ``joint.py``,
``diversify.py``); the guidance
phases ``spsa.*``, ``atp.*``, ``hyb.*`` and ``oracle.score``
(``guidance/``); ``forward``, ``backward``, ``all_reduce``,
``optimizer`` and ``readback`` (``train/trainer.py``);
``denoiser.forward`` (``models/dynamics.py``); ``kernels.gcl_messages``,
``kernels.edge_vector_reduce``, ``kernels.edge_vector_reduce_pair`` and
the backwards ``kernels.gcl_messages_bwd``,
``kernels.edge_vector_reduce_bwd`` (``ops/egnn_kernels.py``).
"""

from __future__ import annotations

import contextlib
import os
import sys
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


def annotate(name: str):
    """A named span on the profiler's timeline while a profiler records
    (decided at entry; the exit matches it, so a span that outlives the
    profiler's start or stop is harmless); else a shared null context:
    no clock read, no synchronisation, nothing allocated.  torch is
    looked up, not imported: where it is not loaded nothing can be
    recording."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


class PhaseProfiler:
    """The named phases of a guided sampling call: ``spsa.{probe, fetch,
    score, apply}``, ``atp.{cand, fetch, score, select}``, ``hyb.{branch,
    look, fetch, score, select}`` and ``decode``, each an ``annotate``
    span; on (``enabled``), also the wall clock of each and of
    ``segment`` (a run of reverse steps from one guidance event to the
    next, across step boundaries, so it is no span).  A ``fetch`` is the
    host copy of the decoded x0 (and of the states and masks scored
    beside it) before scoring.

    On, each phase ends by synchronising the card, so that a phase's time
    holds the work it queued (this serialises the loop: for diagnosis
    only).  Off (the default), ``phase`` is ``annotate`` alone and
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
        return self._phase(name) if self.enabled else annotate(name)

    @contextlib.contextmanager
    def _phase(self, name: str):
        self.begin(name)
        try:
            with annotate(name):
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
