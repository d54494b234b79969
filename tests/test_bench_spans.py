"""The benchmark's reading of the program's spans (``benchmark/spans.py``
and the metric files that call it) on synthetic Chrome traces, as
``benchmark/tests/test_bench_harness.py`` reduces one: each idle gap goes
to the latest-begun program span open at its end on any thread, a span
cut by the window counts for nothing, the profiler's device-side mirrors
of the ranges are not host spans, and a trace without the spans reads
nothing."""

import os

import pytest

from benchmark import harness, spans
from benchmark.harness import Cell, Run
from benchmark.trace import BEGIN, END, Summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP, AUTOGRAD, DEVICE = 1, 2, 7


def x(name, cat, ts, dur, tid=LOOP):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def span(name, ts, dur, tid=LOOP):
    return x(name, "user_annotation", ts, dur, tid)


def kernel(ts, dur):
    return x("void edge_chain_bwd_mma<256, false>(Args)", "kernel", ts, dur,
             DEVICE)


def launch(ts, tid=LOOP):
    return x("cudaLaunchKernel", "cuda_runtime", ts, 2.0, tid)


def run_of(events):
    cell = Cell(name="synthetic", config_name="", traffic_name="", chips=1,
                config={}, traffic={}, trace=True, root=ROOT)
    return Run(cell=cell, trace=Summary(events), traced_steps=2)


def training_trace():
    """A micro-step's tail in 200 us.  Busy 0-30, 60-70, 100-155, 165-180;
    idle 30-60 (ends in the kernel backward on autograd's thread, begun
    after ``backward``), 70-100 (that span has ended: ``backward``),
    155-165 (``optimizer``), 180-200 (in no whole span: ``sampler.step``
    is cut by the window's end)."""
    return [
        x(BEGIN, "user_annotation", 0.0, 0.0),
        span("backward", 10.0, 140.0),
        launch(12.0),
        span("kernels.gcl_messages_bwd", 40.0, 50.0, AUTOGRAD),
        x("aten::mul", "cpu_op", 50.0, 30.0, AUTOGRAD),
        launch(45.0, AUTOGRAD),
        x("kernels.gcl_messages_bwd", "gpu_user_annotation", 95.0, 10.0,
          DEVICE),
        span("optimizer", 158.0, 37.0),
        launch(162.0),
        span("sampler.step", 170.0, 90.0),
        kernel(0.0, 30.0), kernel(60.0, 10.0), kernel(100.0, 55.0),
        kernel(165.0, 15.0),
        x(END, "user_annotation", 200.0, 0.0),
    ]


def sampling_trace(with_spans=True):
    """Two whole steps of 100 us from 10 us, between steps the window
    cut at each end (launches at 5 and 215).  Each step: glue's two
    launches and kernel (busy +20-30), a forward at +40-98 with a
    node-level kernel (+50-55), its wrapper at +60-90 launching at +75 a
    kernel busy +80-95."""
    events = [x(BEGIN, "user_annotation", 0.0, 0.0), launch(5.0)]
    for t0 in (10.0, 110.0):
        events += [launch(t0 + 5), launch(t0 + 15), launch(t0 + 45),
                   launch(t0 + 75)]
        events += [kernel(t0 + 20, 10.0), kernel(t0 + 50, 5.0),
                   kernel(t0 + 80, 15.0)]
        if with_spans:
            events += [span("sampler.step", t0, 100.0),
                       span("denoiser.forward", t0 + 40, 58.0),
                       span("kernels.gcl_messages", t0 + 60, 30.0)]
    events += [launch(215.0), x(END, "user_annotation", 220.0, 0.0)]
    return events


def test_idle_gaps_go_to_the_latest_open_span_on_any_thread():
    run = run_of(training_trace())
    assert run.trace.window_s == pytest.approx(200e-6)
    assert spans.idle_in(run, "kernels") == pytest.approx(15.0)
    assert spans.idle_in(run, "autograd") == pytest.approx(15.0)
    assert spans.idle_in(run, "optimizer") == pytest.approx(5.0)
    # only a cut span of the group: nothing to read
    assert spans.idle_in(run, "sampler") is None
    idle = 100.0 * (1 - run.trace.busy_s / run.trace.window_s)
    assert idle == pytest.approx(45.0)
    assert spans.launches_per_span(run, "backward") == 2.0
    assert spans.launches_per_span(run, "optimizer") == 1.0
    assert spans.launches_per_span(run, "sampler.step") is None


def test_sampling_gaps_and_launches_per_whole_step():
    run = run_of(sampling_trace())
    # idle 0-30 and 105-130 end in a step outside its forward, 40-60 and
    # 140-160 in a forward outside its wrapper, 65-90 and 165-190 in a
    # wrapper; 205-220 in no whole span
    assert spans.idle_in(run, "sampler") == pytest.approx(100 * 55 / 220)
    assert spans.idle_in(run, "denoiser") == pytest.approx(100 * 40 / 220)
    assert spans.idle_in(run, "kernels") == pytest.approx(100 * 50 / 220)
    idle = 100.0 * (1 - run.trace.busy_s / run.trace.window_s)
    assert idle == pytest.approx(100 * 160 / 220)
    # the window's launches per traced step count the cut steps' too
    assert spans.launches_per_span(run, "sampler.step") == 4.0
    assert run.trace.launches() / run.traced_steps == 5.0


METRICS = {
    "idle_sampler.sweep": ("sampling", 100 * 55 / 220),
    "idle_denoiser.sweep": ("sampling", 100 * 40 / 220),
    "idle_kernels.sweep": ("sampling", 100 * 50 / 220),
    "step_launches.sweep": ("sampling", 4.0),
    "step_launches.sample": ("sampling", 4.0),
    "idle_autograd.train": ("training", 15.0),
    "idle_optimizer.train": ("training", 5.0),
    "idle_denoiser.train": ("sampling", 100 * 40 / 220),
    "idle_kernels.train": ("training", 15.0),
}


def test_every_new_metric_is_declared():
    spec = harness.load_spec(ROOT)
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in METRICS:
        assert declared[name]["source"] == "device_trace"
        assert len(declared[name]["workloads"]) == 1


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_reads_its_spans_and_nothing_without_them(name):
    read = harness.reader(name, ROOT)
    kind, want = METRICS[name]
    events = training_trace() if kind == "training" else sampling_trace()
    assert read(run_of(events)) == pytest.approx(want)
    assert read(run_of(sampling_trace(with_spans=False))) is None
    assert read(Run(cell=run_of(events).cell)) is None
