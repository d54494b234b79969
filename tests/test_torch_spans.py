"""The port's spans (``utils.profiling.annotate``) on the CPU, at a tiny
size:

- a profiled conditional sampling run of T steps has T ``sampler.step``
  spans, T + 1 ``denoiser.forward`` spans, one ``decode``, and the
  kernel wrappers' spans inside each forward;
- with no profiler recording, sampling and a training micro-step enter no
  profiler range and read no clock, and give the profiled run's bits;
- a profiled training micro-step has ``forward``, ``backward``,
  ``readback`` and ``optimizer`` once each and a backward span for each
  kernel wrapper call;
- a profiled guided run (SPSA, ATP and the hybrid prune) has every
  guidance phase and ``oracle.score`` as spans, as many as
  ``DIFFNDM_GUIDED_PROFILE=1`` reports, whose report and result the
  profiler leaves alone;
- the primitive itself: one shared null context when off, no fault for a
  span that outlives the profiler's start or stop, and no other call of
  ``record_function`` or NVTX in the package.
"""

import contextlib
import io
import json
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,  # noqa: E402
                                      SPSAConfig, model_config_from_yaml,
                                      train_config_from_yaml)
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.trainer import Trainer  # noqa: E402
from diffndm_tpu_torch.utils import profiling  # noqa: E402

PACKAGE = Path(__file__).resolve().parent.parent / "diffndm_tpu_torch"
HP = {
    "dataset": "crossdock",
    "mode": "pocket_conditioning",
    "pocket_representation": "full-atom",
    "batch_size": 2,
    "lr": 1.0e-3,
    "clip_grad": True,
    "accumulate_grad_batches": 1,
    "ema_decay": 0.9,
    "egnn_params": {
        "joint_nf": 8, "hidden_nf": 16, "n_layers": 2, "inv_sublayers": 1,
        "attention": True, "tanh": True, "norm_constant": 1,
        "reflection_equivariant": False, "edge_cutoff_ligand": None,
        "edge_cutoff_pocket": 5.0, "edge_cutoff_interaction": 5.0},
    "diffusion_params": {
        "diffusion_steps": 10, "diffusion_noise_schedule": "polynomial_2",
        "diffusion_noise_precision": 5.0e-4, "diffusion_loss_type": "l2",
        "normalize_factors": [1, 4]},
}
ROWS, NP, SIZES = 2, 12, np.array([5, 7])
KERNEL_SPANS = ("kernels.gcl_messages", "kernels.edge_vector_reduce",
                "kernels.edge_vector_reduce_pair")
GUIDED = SampleConfig(
    n_samples=ROWS,
    spsa=SPSAConfig(enabled=True, num_probes=2, start_step=2, every=2),
    atp=ATPConfig(enabled=True, num_groups=2, start_step=3, every=3))


def model(sample_cfg=None):
    torch.manual_seed(0)
    return DiffNDM(model_config_from_yaml(HP), sample_cfg or SampleConfig(
        n_samples=ROWS), device="cpu", scorer="python")


def pocket(m):
    g = torch.Generator().manual_seed(1)
    x = 3.0 * torch.randn(ROWS, NP, 3, generator=g)
    types = torch.randint(0, m.cfg.residue_nf, (ROWS, NP), generator=g)
    h = torch.nn.functional.one_hot(types, m.cfg.residue_nf).float()
    return NodeBatch(x, h, torch.ones(ROWS, NP))


def sample(m, timesteps):
    return m.sample_given_pocket(
        pocket(m), SIZES, timesteps=timesteps,
        generator=torch.Generator().manual_seed(2))


def micro_step(trainer, m):
    g = torch.Generator().manual_seed(3)
    nl = int(SIZES.max())
    types = torch.randint(0, m.cfg.atom_nf, (ROWS, nl), generator=g)
    lig = NodeBatch(torch.randn(ROWS, nl, 3, generator=g),
                    torch.nn.functional.one_hot(types, m.cfg.atom_nf).float(),
                    (torch.arange(nl)[None] < torch.as_tensor(
                        SIZES)[:, None]).float())
    t = torch.tensor([3, 7])
    noise = torch.randn(ROWS, nl, 3 + m.cfg.atom_nf, generator=g)
    return trainer.train_step(lig, pocket(m), t_int=t, noise=noise)


def trainer_of(m):
    return Trainer(m.core, m.dynamics, train_config_from_yaml(HP))


def spans(tmp_path, fn):
    """fn() under ``profiling.trace``: its result and the spans of the
    Chrome trace written, as (name, start, end, thread)."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    return out, [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid"))
                 for e in events if e.get("cat") == "user_annotation"]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def named(found, *names):
    return [s for s in found if s[0] in names]


def test_sampling_spans_nest_step_forward_kernels(tmp_path):
    T = 3
    _, found = spans(tmp_path, lambda: sample(model(), T))
    count = Counter(s[0] for s in found)
    assert count["sampler.step"] == T
    assert count["denoiser.forward"] == T + 1
    assert count["decode"] == 1
    assert count["facade.sample_given_pocket"] == 1
    steps, decode = named(found, "sampler.step"), named(found, "decode")[0]
    kernels = named(found, *KERNEL_SPANS)
    for fwd in named(found, "denoiser.forward"):
        assert sum(inside(fwd, s) for s in steps + [decode]) == 1
        assert sum(inside(k, fwd) for k in kernels) >= 2
    assert all(any(inside(k, f) for f in named(found, "denoiser.forward"))
               for k in kernels)


class _Refused(RuntimeError):
    pass


def _refuse(*args, **kwargs):
    raise _Refused("a profiler range or a clock read with tracing off")


def test_off_path_enters_no_range_and_changes_no_bit(tmp_path, monkeypatch):
    def run():
        m = model()
        res = sample(m, 3)
        loss, info = micro_step(trainer_of(m), m)
        return res, loss, info, [p.detach().clone()
                                 for p in m.dynamics.parameters()]

    traced, found = spans(tmp_path, run)
    assert named(found, "sampler.step") and named(found, "readback")
    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _Refused)
        mp.setattr(torch.autograd.profiler, "record_function", _Refused)
        mp.setattr(profiling, "time", type("Clock", (), dict(
            perf_counter=staticmethod(_refuse), time=staticmethod(_refuse))))
        with pytest.raises(_Refused):
            profiling.PhaseProfiler(True).begin("probe")
        plain = run()
    res_a, loss_a, info_a, params_a = traced
    res_b, loss_b, info_b, params_b = plain
    for a, b in zip((*res_a.ligand, *res_a.pocket),
                    (*res_b.ligand, *res_b.pocket)):
        assert torch.equal(a, b)
    assert loss_a == loss_b and info_a == info_b
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_training_micro_step_spans(tmp_path):
    m = model()
    trainer = trainer_of(m)
    _, found = spans(tmp_path, lambda: micro_step(trainer, m))
    count = Counter(s[0] for s in found)
    for name in ("forward", "backward", "readback", "optimizer"):
        assert count[name] == 1, name
    assert count["all_reduce"] == 0
    assert count["kernels.gcl_messages_bwd"] == \
        count["kernels.gcl_messages"] > 0
    assert count["kernels.edge_vector_reduce_bwd"] == \
        count["kernels.edge_vector_reduce"] + \
        count["kernels.edge_vector_reduce_pair"] > 0
    order = [named(found, n)[0] for n in ("forward", "backward", "optimizer",
                                          "readback")]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    fwd, bwd = order[:2]
    assert all(inside(k, bwd) for k in named(
        found, "kernels.gcl_messages_bwd", "kernels.edge_vector_reduce_bwd"))
    assert all(inside(k, fwd) for k in named(found, *KERNEL_SPANS))


def report_counts(text):
    """{phase: calls} of a printed PhaseProfiler report."""
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^  (\S+)\s+[0-9.]+  x(\d+)$", text, re.M)}


def test_guided_phases_and_oracle_are_spans(tmp_path, monkeypatch):
    T = 4
    monkeypatch.setenv("DIFFNDM_GUIDED_PROFILE", "1")

    def run():
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = sample(model(GUIDED), T)
        return res, text.getvalue()

    plain, plain_text = run()
    (traced, traced_text), found = spans(tmp_path, run)
    report = report_counts(traced_text)
    assert report == report_counts(plain_text)
    for a, b in zip((*plain.ligand, plain.row_src),
                    (*traced.ligand, traced.row_src)):
        assert torch.equal(a, b)
    phases = {f"{e}.{p}" for e, ps in (
        ("spsa", ("probe", "fetch", "score", "apply")),
        ("atp", ("cand", "fetch", "score", "select")),
        ("hyb", ("branch", "look", "fetch", "score", "select")))
        for p in ps}
    assert phases | {"segment", "decode"} == set(report)
    count = Counter(s[0] for s in found)
    for phase in phases | {"decode"}:
        assert count[phase] == report[phase], phase
    scores = named(found, "oracle.score")
    phase_scores = named(found, "spsa.score", "atp.score", "hyb.score")
    assert all(any(inside(o, s) for s in phase_scores) for o in scores)
    assert all(any(inside(o, s) for o in scores) for s in phase_scores)
    assert count["sampler.step"] == T


def test_annotate_is_one_shared_null_context_when_off(tmp_path):
    assert not torch.autograd._profiler_enabled()
    off = profiling.annotate("sampler.step")
    assert off is profiling.annotate("decode")
    with off, off:
        pass
    from torch.profiler import ProfilerActivity, profile

    # a span entered before the profiler starts and one left after it
    # stops: neither raises, and only the whole span is recorded whole
    before = profiling.annotate("before")
    before.__enter__()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    after = profiling.annotate("after")
    after.__enter__()
    with profiling.annotate("whole"):
        torch.ones(3).sum()
    prof.stop()
    after.__exit__(None, None, None)
    before.__exit__(None, None, None)
    names = [e.name for e in prof.events()]
    assert "whole" in names and "before" not in names


def test_no_other_range_or_nvtx_call_in_the_package():
    pattern = re.compile(r"record_function|nvtx|range_push")
    found = [f"{p.relative_to(PACKAGE)}:{i}"
             for p in sorted(PACKAGE.rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if pattern.search(line) and p.name != "profiling.py"]
    assert found == []
    text = (PACKAGE / "utils" / "profiling.py").read_text()
    assert "nvtx" not in text and text.count("record_function(") == 1
