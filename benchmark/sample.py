"""Sampling cells: pocket batches through the program's facade,
``DiffNDM.sample_given_pocket`` and ``DiffNDM.result_to_molecules``, back
to back in a closed loop of one caller for the window's length.

Set-up builds the model, hands it the weights, makes the pockets and the
ligand sizes, and warms the cell's own shapes with a two-step batch.  The
weights, the pockets and the multiset of ligand sizes are the cell's own,
from fixed seeds in its files; the run's seed draws the noise and the
order of the sizes, so that every seed gives the same amount of work.  Each
batch then gets its own noise (drawn on the device from the seed) and
returns its ligands as molecules.  The batch in flight when the window
closes counts by the share of its denoiser forwards done: a forward
pre-hook on the denoiser notes each forward and, at the close,
synchronises the card, reads the clock and stops the batch.

The same hooks capture, for a sample of steps drawn from the seed, the
denoiser's inputs and output, and the next step's input; after the
window the reference (``reference/``) recomputes them from the program's
own state (``check``).  With ``--trace 1`` a few steps are profiled
(``trace.Recorder``), and every forward's inputs are kept to count the
edges they need once the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import costs
from benchmark import traffic as TR
from benchmark import weights as W
from benchmark.harness import Cell, Run
from benchmark.reference import diffusion as RD
from benchmark.reference.egnn import Reference
from benchmark.trace import Recorder


class WindowClosed(Exception):
    """Raised by the denoiser's pre-hook once the window has closed."""


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Probe:
    """The benchmark's hooks on the program's denoiser."""

    def __init__(self, deadline: float, recorder=None, trace_at: int = -1,
                 trace_len: int = 0, keep_all: bool = False):
        self.deadline = deadline
        self.recorder = recorder
        self.trace_at, self.trace_len = trace_at, trace_len
        self.keep_all = keep_all
        self.forwards = 0              # forwards begun in the current batch
        self.total = 0
        self.capture: set = set()
        self.captured: Dict[int, list] = {}
        self.records: List[tuple] = []

    def begin_batch(self, capture) -> None:
        self.forwards = 0
        self.capture = set(capture)
        self.captured = {}

    def pre(self, module, args):
        if time.perf_counter() >= self.deadline:
            raise WindowClosed
        rec = self.recorder
        if rec is not None:
            if self.total == self.trace_at:
                rec.start()
            elif rec.active and self.total == self.trace_at + self.trace_len:
                rec.stop()
        if self.forwards in self.capture:
            self.captured[self.forwards] = [args[:5], None]
        if self.keep_all:
            self.records.append((args[0], args[1], args[3], args[4],
                                 rec is not None and rec.active))
        self.forwards += 1
        self.total += 1

    def post(self, module, args, out):
        f = self.forwards - 1
        if f in self.captured:
            self.captured[f][1] = out[0]


def capture_set(seed: int, batch: int, timesteps: int, n_random: int):
    """The forwards whose inputs and output a batch keeps: the first two
    (the start and the first step), the last step and the decode, and
    ``n_random`` steps drawn from the seed with the forward after each."""
    g = TR.rng(seed, 10, batch)
    ks = g.choice(np.arange(1, timesteps - 1), size=n_random, replace=False)
    out = {0, 1, timesteps - 1, timesteps}
    for k in ks:
        out |= {int(k), int(k) + 1}
    return out


class SampleSetup:
    """The model, its weights, the pocket batch, sizes and noise of a
    sampling cell."""

    def __init__(self, cell: Cell, device):
        from diffndm_tpu_torch.config import SampleConfig, model_config_from_yaml
        from diffndm_tpu_torch.model import DiffNDM

        tr, cfg = cell.traffic, cell.config
        self.cell, self.device = cell, torch.device(device)
        self.hp = cfg["hparams"]["egnn_params"]
        self.model_cfg = model_config_from_yaml(cfg["hparams"])
        self.atom_nf = self.model_cfg.atom_nf
        self.norm = tuple(self.model_cfg.diffusion.norm_values)
        self.timesteps = int(tr["timesteps"])
        pocket = tr["pocket"]
        if pocket["kind"] == "synthetic":
            pockets = [TR.synthetic_pocket(pocket["seed"], pocket["atoms"],
                                           pocket["density"],
                                           pocket["type_probs"])]
        else:
            pockets = TR.test_set_pockets(
                TR.repo_path(cell.root, pocket["path"]), pocket["first"])
        per = int(tr["per_pocket"])
        self.rows = per * len(pockets)
        sample_cfg = SampleConfig(
            n_samples=self.rows, timesteps=self.timesteps,
            sanitize=tr["decode"]["sanitize"],
            largest_frag=tr["decode"]["largest_frag"],
            lig_pad_multiple=tr["lig_pad_multiple"],
            pocket_pad_multiple=tr["pocket_pad_multiple"])
        self.model = DiffNDM(self.model_cfg, sample_cfg, device=self.device)
        w = cfg["weights"]
        if w["kind"] == "seeded":
            self.weights = W.seeded(self.hp, self.atom_nf,
                                    self.model_cfg.residue_nf, w["seed"],
                                    self.device, w)
        else:
            self.weights = W.from_npz(TR.repo_path(cell.root, w["path"]),
                                      self.device)
        self.model.set_params(W.program_state(self.weights))
        x, h, mask = TR.pocket_batch(pockets, per, self.model_cfg.residue_nf,
                                     tr["pocket_pad_multiple"], self.device)
        from diffndm_tpu_torch.structs import NodeBatch

        self.pocket = NodeBatch(x, h, mask)
        lig = tr["ligand"]
        if lig["kind"] == "fixed":
            self.sizes = np.full(self.rows, int(lig["atoms"]))
        else:
            counts = np.array([len(p) for p, _ in pockets]).repeat(per)
            self.sizes = TR.prior_sizes(TR.default_histogram(), counts,
                                        lig["size_seed"], cell.seed, per)
        self.nl = TR.pad_to(int(self.sizes.max()), tr["lig_pad_multiple"])
        # the masks the denoiser has to be given, worked out here from the
        # sizes and pockets the benchmark drew
        self.lig_mask = TR.ligand_mask(self.sizes, tr["lig_pad_multiple"],
                                       self.device)
        self.molecules_s = 0.0

    def noise(self, batch: int, timesteps: Optional[int] = None):
        """The batch's noise, one normal draw on the device."""
        from diffndm_tpu_torch.diffusion.sampler import SamplerNoise

        t = timesteps or self.timesteps
        shape = (self.rows, self.nl, 3 + self.atom_nf)
        g = TR.device_generator(self.cell.seed, 1000 + batch, self.device)
        flat = torch.randn((t + 2,) + shape, generator=g, device=self.device)
        return SamplerNoise(init=flat[0], steps=flat[1:t + 1],
                            decode=flat[t + 1])

    def batch(self, noise, timesteps=None):
        """One pocket batch and its molecules; the host clock of the
        molecules (bond perception and the filters, after the card has
        finished the batch, which their first copy to the host waits for
        anyway) is summed in ``molecules_s``."""
        res = self.model.sample_given_pocket(self.pocket, self.sizes,
                                             timesteps=timesteps,
                                             noise=noise)
        sync(self.device)
        t0 = time.perf_counter()
        mols = self.model.result_to_molecules(res)
        self.molecules_s += time.perf_counter() - t0
        return res, mols


def run(cell: Cell, device, t_process: float) -> Run:
    device = torch.device(device)
    s = SampleSetup(cell, device)
    tr = cell.traffic
    # the cell's shapes once: the kernels' build and load, the scorer-free
    # host path, the allocator's blocks
    s.batch(s.noise(-1, 2), timesteps=2)
    s.molecules_s = 0.0
    recorder = None
    if cell.trace:
        Recorder.warm()
        recorder = Recorder()
    hooks = tr["check"]
    sync(device)
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    probe = Probe(t_start + cell.seconds, recorder,
                  trace_at=tr["trace"]["first_forward"] if cell.trace else -1,
                  trace_len=tr["trace"]["forwards"], keep_all=cell.trace)
    h_pre = s.model.dynamics.register_forward_pre_hook(probe.pre)
    h_post = s.model.dynamics.register_forward_hook(probe.post)
    finished, batch, partial, current = [], 0, 0.0, None
    per_batch = s.timesteps + 1
    try:
        while time.perf_counter() < probe.deadline:
            noise = s.noise(batch)
            probe.begin_batch(capture_set(cell.seed, batch, s.timesteps,
                                          hooks["random_steps"]))
            current = (probe.captured, noise, None)
            res, mols = s.batch(noise)
            if len(mols) != s.rows:
                raise RuntimeError(f"{len(mols)} molecules for {s.rows} rows")
            finished.append((probe.captured, noise, res.ligand))
            batch += 1
    except WindowClosed:
        partial = s.rows * probe.forwards / per_batch
    sync(device)
    t_end = time.perf_counter()
    h_pre.remove()
    h_post.remove()
    if recorder is not None and recorder.active:
        recorder.stop()
    out = Run(cell=cell, setup_s=setup_s, window_s=t_end - t_start)
    out.work["ligands"] = s.rows * len(finished) + partial
    out.spans["molecules_s"] = s.molecules_s
    out.attempted = s.rows * len(finished)
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    inflight = current if partial else None
    if cell.trace:
        _trace_costs(out, s, probe.records, recorder, t_end - t_start)
    del probe
    s.model = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.checks = check(s, cell, finished, inflight, cell.control)
    return out


def _trace_costs(out: Run, s, records, recorder, window_s: float) -> None:
    """The traced part's least kernel time and the untraced part's model
    FLOPs and host clock (``costs.window_costs``)."""
    peak = costs.peaks(torch.cuda.get_device_name(0)) if \
        s.device.type == "cuda" else None
    least, out.traced_steps, out.untraced_flops = costs.window_costs(
        records, s.hp, peak, backward=False)
    out.fwd_least_s = least
    out.trace = recorder.summary
    out.untraced_s = window_s - recorder.host_s
    if peak is not None:
        out.peak_flops = peak[costs.PRECISION_PEAK[
            s.hp.get("compute_dtype", "float32")]]


def _gap(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """max |a - b| / max |b| over the real rows, the coordinates and the
    features each on their own scale; the larger of the two."""
    m = mask[..., None] > 0
    worst = 0.0
    for part in (slice(0, 3), slice(3, None)):
        pa, pb = a[..., part], b[..., part]
        if pb.shape[-1] == 0:
            continue
        mm = m.expand_as(pb)
        den = pb.abs()[mm].max().item()
        num = (pa - pb).abs()[mm].max().item()
        worst = max(worst, num / den if den > 0 else num)
    return worst


def reference_inputs(s: SampleSetup, f: int):
    """The time and masks the denoiser has to get at forward ``f`` of a
    batch, from the benchmark's own schedule, sizes and pockets: t = (s +
    1) / T at the step from s + 1 to s (f = T - 1 - s), 0 at the decode
    (f = T)."""
    T = s.timesteps
    step = T - 1 - f
    t = torch.full((s.rows,), float(step + 1) / T if f < T else 0.0,
                   dtype=torch.float32, device=s.device)
    return t, s.lig_mask, s.pocket.mask


def inputs_gap(inputs, expected) -> float:
    """The gap of the program's denoiser inputs (t, ligand mask, pocket
    mask) to those it has to get: t's widest gap over the largest
    expected time (absolute at the decode's 0), a mask that differs 1."""
    t, lm, pm = inputs
    t_ref, lm_ref, pm_ref = expected
    if (lm.shape != lm_ref.shape or pm.shape != pm_ref.shape
            or not torch.equal(lm, lm_ref) or not torch.equal(pm, pm_ref)):
        return 1.0
    t = torch.as_tensor(t, dtype=t_ref.dtype, device=t_ref.device)
    t = t.expand(t_ref.shape) if t.dim() == 0 else t
    if t.shape != t_ref.shape:
        return 1.0
    den = t_ref.abs().max().item()
    num = (t - t_ref).abs().max().item()
    return num / den if den > 0 else num


def readings(s: SampleSetup, gamma, cap, noise, ligand, eps_of,
             ref: Reference, program: bool = True) -> Dict[str, float]:
    """The numbers compared for one batch, each the widest relative gap
    to the reference (``_gap``): ``eps_gap`` of the denoiser's output at
    the captured forwards, ``state_gap`` of the sampler's state after the
    start, each captured step and the decode (a decoded type that differs
    reads 1), and of the time and masks the program gave the denoiser
    (``inputs_gap``).  The reference is given the time and masks worked
    out by the benchmark (``reference_inputs``), never the program's.
    ``eps_of(f, inputs)`` is the side judged: the program's captured
    output, or the control given the reference's inputs.  The program's
    states are its own (``ligand`` its decoded ligand, None for a batch
    still in flight); the control's (``program`` False) are the
    reference's step on the control's eps.  Both start each step from
    the program's captured state.
    """
    eps_gap = state_gap = 0.0
    compared = 0
    T = s.timesteps
    for f in sorted(cap):
        t_ref, lm, pm = expected = reference_inputs(s, f)
        if program:
            gap = inputs_gap(cap[f][0][2:5], expected)
            if gap >= 1.0:
                return {"eps_gap": 1.0, "state_gap": 1.0}
            state_gap = max(state_gap, gap)
        if f == T or f + 1 not in cap:
            continue
        z, p = cap[f][0][:2]
        inputs = (z, p, t_ref, lm, pm)
        sidx = T - 1 - f
        e_ref = ref.eps(*inputs)
        e_side = eps_of(f, inputs)
        eps_gap = max(eps_gap, _gap(e_side, e_ref, lm))
        compared += 1
        z_ref, p_ref = RD.step(gamma, sidx, z, p, e_ref, noise.steps[sidx],
                               lm, pm)
        if program:
            z_side, p_side = cap[f + 1][0][0], cap[f + 1][0][1]
        else:
            z_side, p_side = RD.step(gamma, sidx, z, p, e_side,
                                     noise.steps[sidx], lm, pm)
        state_gap = max(state_gap, _gap(z_side, z_ref, lm),
                        _gap(p_side[..., :3], p_ref[..., :3], pm))
    if 0 in cap and program:
        z0, p0 = cap[0][0][:2]
        _, lm, pm = reference_inputs(s, 0)
        z_ref, p_ref = RD.start(s.pocket.x, s.pocket.h, lm, pm, noise.init,
                                s.norm, s.atom_nf)
        state_gap = max(state_gap, _gap(z0, z_ref, lm),
                        _gap(p0, p_ref, pm))
    if T in cap and cap[T][1] is not None and (ligand is not None
                                                or not program):
        t_ref, lm, pm = reference_inputs(s, T)
        z, p = cap[T][0][:2]
        inputs = (z, p, t_ref, lm, pm)
        e_ref = ref.eps(*inputs)
        e_side = eps_of(T, inputs)
        eps_gap = max(eps_gap, _gap(e_side, e_ref, lm))
        x_ref, h_ref = RD.decode(gamma, z, p, e_ref, noise.decode, lm, pm,
                                 s.pocket.x, s.pocket.mask, s.norm, s.atom_nf)
        if program:
            x_side, h_side = ligand.x, ligand.h
        else:
            x_side, h_side = RD.decode(gamma, z, p, e_side, noise.decode, lm,
                                       pm, s.pocket.x, s.pocket.mask, s.norm,
                                       s.atom_nf)
        if not torch.equal(h_side * lm[..., None], h_ref):
            state_gap = max(state_gap, 1.0)
        state_gap = max(state_gap, _gap(x_side, x_ref, lm))
    if not compared:
        raise RuntimeError("the chosen batch reached no captured step")
    return {"eps_gap": eps_gap, "state_gap": state_gap}


def chosen(cell: Cell, finished, inflight):
    """The batch the check compares, drawn from the seed among the
    finished ones (the one in flight where none finished)."""
    if finished:
        return finished[int(TR.rng(cell.seed, 20).integers(len(finished)))]
    return inflight


def check(s: SampleSetup, cell: Cell, finished, inflight,
          control: bool = False) -> Dict[str, dict]:
    """The readings of the program (and with ``control`` those of the
    reference in TF32 in its place) against their limits."""
    lim = cell.traffic["check"]["limits"]
    pick = chosen(cell, finished, inflight)
    out = {}
    if pick is None:
        raise RuntimeError("the window began no batch")
    cap, noise, ligand = pick
    dp = cell.config["hparams"]["diffusion_params"]
    if dp["diffusion_steps"] != s.timesteps:
        raise ValueError("the check follows runs of the schedule's own T")
    gamma = torch.as_tensor(RD.gamma_table(
        dp["diffusion_noise_schedule"], s.timesteps,
        dp["diffusion_noise_precision"]), device=s.device)
    block = cell.traffic["check"]["block_rows"]
    ref = Reference(s.weights, s.hp, "fp32", block)
    got = readings(s, gamma, cap, noise, ligand,
                   lambda f, inputs: cap[f][1], ref)
    for k, v in got.items():
        out[k] = {"value": v, "limit": lim[k]}
    if control:
        low = Reference(s.weights, s.hp, "tf32", block)
        ctl = readings(s, gamma, cap, noise, None,
                       lambda f, inputs: low.eps(*inputs), ref, False)
        for k, v in ctl.items():
            out["control." + k] = {"value": v, "limit": lim[k]}
    return out
