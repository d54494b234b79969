"""A traced sub-window: ``torch.profiler`` over a few whole steps of the
measured loop (the use of ``diffndm_tpu_torch/utils/profiling.trace``,
CPU and CUDA activity), started and stopped at step boundaries with the
card synchronised, reduced from its Chrome trace to what the per-layer
readers need: device activity, kernel time by name, runtime launch calls,
idle gaps and what the host was doing in them, and the benchmark's own
spans.

The trace file is written under the run's temporary directory and
deleted once read.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

BEGIN, END = "bench.trace.begin", "bench.trace.end"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel(ExC|Ex)?|GraphLaunch|"
                    r"LaunchCooperativeKernel)(_v\d+)?$")


class Recorder:
    """Starts and stops one profiler session at step boundaries and
    keeps the host clock spent inside it (profiler start, stop and the
    two synchronisations), which the untraced part of the window leaves
    out."""

    def __init__(self):
        self.prof = None
        self.summary: Optional["Summary"] = None
        self.host_s = 0.0
        self._t0 = 0.0

    @staticmethod
    def warm() -> None:
        """One short session during set-up, so that the profiler's own
        initialisation stays out of the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with torch.profiler.record_function(BEGIN):
            pass

    def stop(self) -> None:
        torch.cuda.synchronize()
        with torch.profiler.record_function(END):
            pass
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = Summary(events)
        self.host_s += time.perf_counter() - self._t0


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Summary:
    """The traced sub-window, times in seconds."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("ph") == "X"]
        marks = {e["name"]: e for e in spans
                 if e.get("name") in (BEGIN, END)}
        self.t0, self.t1 = marks[BEGIN]["ts"], marks[END]["ts"]
        self.tid = marks[BEGIN].get("tid")
        inside = [e for e in spans
                  if e["ts"] >= self.t0 and e["ts"] + e.get("dur", 0)
                  <= self.t1 + 1.0]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in inside if e.get("cat") in HOST_CATS
                     and e["name"] not in (BEGIN, END)]
        self.runtime = [e for e in inside if e.get("cat") == "cuda_runtime"]
        busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in self.device])
        self.busy = busy
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.busy_s = sum(b - a for a, b in busy) * 1e-6

    def kernel_seconds(self, pattern: str) -> float:
        """Device time of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return 1e-6 * sum(e["dur"] for e in self.device
                          if e.get("cat") == "kernel" and rx.search(e["name"]))

    def launches(self) -> int:
        """Runtime calls that launch a kernel or a graph."""
        return sum(1 for e in self.runtime if LAUNCH.match(e["name"]))

    def span_seconds(self, name: str) -> float:
        return 1e-6 * sum(e["dur"] for e in self.host if e["name"] == name)

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for e in self.device:
            total[e["name"][:160]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                           key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time on the device summed by what the host was doing: the
        innermost host operation of the loop's thread open when the gap
        ended, the one whose launch the card waited for."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted((e for e in self.host if e.get("tid") == self.tid),
                      key=lambda e: e["ts"])
        total: Dict[str, float] = defaultdict(float)
        stack: List[dict] = []
        i = 0
        for a, b in gaps:
            while i < len(host) and host[i]["ts"] <= b:
                e = host[i]
                while stack and _end(stack[-1]) <= e["ts"]:
                    stack.pop()
                stack.append(e)
                i += 1
            while stack and _end(stack[-1]) < b:
                stack.pop()
            name = stack[-1]["name"][:160] if stack else "(no host op)"
            total[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                           key=lambda kv: -kv[1])[:top]]


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)
