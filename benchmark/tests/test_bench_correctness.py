"""The correctness comparison on the CPU at a tiny size: the reference
against the program's plain path, the control (the reference with its
products in TF32) read as not correct, and a run with the timed path
broken underneath read as not correct, once per fault a sampling cell
can have."""

import numpy as np
import pytest
import torch

from bench_util import run_tiny, tiny
from conftest import ROOT

CELLS = ("cd_sample_b100", "v3b_sweep_b160")
TRAIN = ("cd_train_b16",)


def _cell(spec, name, keep_weights=False):
    from benchmark import harness

    return tiny(harness.load_cell(name, spec, ROOT), keep_weights=keep_weights)


def _correct(run):
    return all(c["value"] <= c["limit"] for k, c in run.checks.items()
               if not k.startswith("control."))


def test_reference_denoiser_and_step_match_the_program():
    """Seeded weights at hidden 32: the reference's eps equals the
    program's plain forward to fp32 rounding; its schedule is the
    program's table bit for bit; one reverse step from the same state,
    eps and noise agrees."""
    from benchmark import weights as W
    from benchmark.reference import diffusion as RD
    from benchmark.reference.egnn import Reference
    from diffndm_tpu_torch.config import load_yaml, model_config_from_yaml
    from diffndm_tpu_torch.diffusion.schedules import gamma_table
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.config import SampleConfig

    raw = load_yaml(f"{ROOT}/configs/crossdock_fullatom_cond.yml")
    raw["egnn_params"].update(hidden_nf=32, joint_nf=16, n_layers=2)
    cfg = model_config_from_yaml(raw)
    model = DiffNDM(cfg, SampleConfig(), device="cpu")
    w = W.seeded(raw["egnn_params"], cfg.atom_nf, cfg.residue_nf, 11, "cpu",
                 dict(kernel_gain=0.5, out_gain=0.5, bias_std=0.1))
    model.set_params(W.program_state(w))
    g = torch.Generator().manual_seed(0)
    b, nl, npk = 3, 8, 40
    z = torch.randn(b, nl, 13, generator=g)
    p = torch.randn(b, npk, 13, generator=g) * 3
    lm = torch.ones(b, nl)
    lm[0, 6:] = 0
    pm = torch.ones(b, npk)
    pm[1, 30:] = 0
    z, p = z * lm[..., None], p * pm[..., None]
    t = torch.rand(b, generator=g)
    with torch.no_grad():
        e_prog, _ = model.dynamics(z, p, t, lm, pm)
    e_ref = Reference(w, raw["egnn_params"]).eps(z, p, t, lm, pm)
    scale = e_ref.abs().max()
    assert (e_prog - e_ref).abs().max() <= 1e-5 * scale
    table = RD.gamma_table("polynomial_2", 500, 5e-4)
    assert np.array_equal(table, gamma_table("polynomial_2", 500, 5e-4))
    gamma = torch.as_tensor(table)
    noise = torch.randn(b, nl, 13, generator=g)
    s = 317
    z_ref, p_ref = RD.step(gamma, s, z, p, e_ref, noise, lm, pm)
    s_norm = torch.full((b,), float(s)) / 500
    t_norm = torch.full((b,), float(s + 1)) / 500
    z_prog, p_prog, _, _ = model.core.sample_p_zs_given_zt(
        s_norm, t_norm, z, p, lm, pm, lambda *a: (e_ref, None),
        noise=noise)
    assert (z_prog - z_ref).abs().max() <= 1e-5 * z_ref.abs().max()
    assert (p_prog - p_ref).abs().max() <= 1e-5 * p_ref.abs().max()


@pytest.mark.parametrize("name", CELLS + TRAIN)
def test_control_reads_not_correct(spec, name):
    """The reference with TF32 products, in the program's place, fails at
    least one of the cell's limits."""
    cell = _cell(spec, name, keep_weights=True)
    cell.control = True
    run = run_tiny(cell, seconds=3.0)
    assert _correct(run)
    failed = [k for k, c in run.checks.items()
              if k.startswith("control.") and c["value"] > c["limit"]]
    assert failed, run.checks


def _same_state_step(core_cls):
    def step(self, s_norm, t_norm, z_lig, xh_pocket, lig_mask, pocket_mask,
             eps_fn, **kw):
        eps, _ = eps_fn(z_lig, xh_pocket, t_norm, lig_mask, pocket_mask)
        return z_lig, xh_pocket, 0.0, eps
    return step


def _half_batch_forward(original):
    def forward(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask, **kw):
        half = xh_lig.shape[0] // 2
        t = torch.as_tensor(t).expand(xh_lig.shape[0])
        eps_l, eps_p = original(self, xh_lig[:half], xh_pocket[:half],
                                t[:half], lig_mask[:half], pocket_mask[:half],
                                **kw)
        rest = xh_lig.shape[0] - half
        fill_l = eps_l.mean(0, keepdim=True).expand(rest, *eps_l.shape[1:])
        fill_p = eps_p.mean(0, keepdim=True).expand(rest, *eps_p.shape[1:])
        return (torch.cat([eps_l, fill_l]) * lig_mask[..., None],
                torch.cat([eps_p, fill_p]) * pocket_mask[..., None])
    return forward


def _shifted_time(original):
    """A reverse step whose denoiser is given the time one step off (s
    in place of s + 1) while the step's own schedule stays right."""
    def step(self, s_norm, t_norm, z_lig, xh_pocket, lig_mask, pocket_mask,
             eps_fn, **kw):
        def shifted(z, p, t, lm, pm):
            return eps_fn(z, p, s_norm, lm, pm)
        return original(self, s_norm, t_norm, z_lig, xh_pocket, lig_mask,
                        pocket_mask, shifted, **kw)
    return step


def _sizes_ignored(self, num_nodes_lig, device):
    """A ligand mask of the batch's whole padded width, whatever the
    sizes drawn."""
    sizes = np.asarray(num_nodes_lig)
    nl = -(-int(sizes.max()) // self.cfg.lig_pad_multiple) \
        * self.cfg.lig_pad_multiple
    return torch.ones(len(sizes), nl, device=device)


def _altered_decode(original, what):
    def decode(self, *args, **kw):
        x, h, xp, hp = original(self, *args, **kw)
        x, h = x.clone(), h.clone()
        if what == "type":
            h[0, 0] = torch.roll(h[0, 0], 1)
        else:
            x[0, 0, 0] += 0.1
        return x, h, xp, hp
    return decode


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "type_altered", "coordinate_altered",
                                   "time_shifted"])
def test_a_broken_timed_path_reads_not_correct(spec, monkeypatch, name,
                                               fault):
    """The harness's whole run but the look for a card, with the program
    broken underneath: a reverse step that returns its state unchanged;
    the denoiser on half the batch, the rest given its mean; a decoded
    atom's type or coordinate altered where it is produced; the denoiser
    given the time one step off.  (A sampling cell runs on one card: it
    has no exchange between cards to leave out.)"""
    from diffndm_tpu_torch.diffusion.core import CondDiffusion
    from diffndm_tpu_torch.models.dynamics import EGNNDynamics

    if fault == "state_unchanged":
        monkeypatch.setattr(CondDiffusion, "sample_p_zs_given_zt",
                            _same_state_step(CondDiffusion))
    elif fault == "half_batch":
        monkeypatch.setattr(EGNNDynamics, "forward",
                            _half_batch_forward(EGNNDynamics.forward))
    elif fault == "time_shifted":
        monkeypatch.setattr(CondDiffusion, "sample_p_zs_given_zt",
                            _shifted_time(CondDiffusion.sample_p_zs_given_zt))
    else:
        monkeypatch.setattr(CondDiffusion, "sample_p_xh_given_z0",
                            _altered_decode(CondDiffusion.sample_p_xh_given_z0,
                                            fault.split("_")[0]))
    run = run_tiny(_cell(spec, name), seconds=4.0)
    assert not _correct(run), run.checks


def test_ignored_ligand_sizes_read_not_correct(spec, monkeypatch):
    """The sweep's rows have sizes of their own: a sampler that masks
    the whole padded width in place of the drawn sizes reads not
    correct."""
    from diffndm_tpu_torch.diffusion.sampler import ConditionalSampler

    cell = _cell(spec, "v3b_sweep_b160")
    cell.traffic["pocket"]["first"] = 3
    monkeypatch.setattr(ConditionalSampler, "ligand_mask", _sizes_ignored)
    run = run_tiny(cell, seconds=4.0)
    assert not _correct(run), run.checks


def _frozen_update(self, params, grads):
    return False


def _frozen_after_setup(original):
    """An optimizer that updates the weights through set-up's first
    micro-steps and leaves them unchanged in the window, as a step
    replayed from a stale capture would."""
    def update(self, params, grads):
        if self.count >= 2:
            return False
        return original(self, params, grads)
    return update


def _half_batch_loss(original):
    def loss(self, ligand, pocket, training, t_int=None, noise=None,
             **kw):
        from diffndm_tpu_torch.structs import NodeBatch

        half = ligand.x.shape[0] // 2
        cut = lambda nb: NodeBatch(*(v[:half] for v in nb))
        return original(self, cut(ligand), cut(pocket), training,
                        None if t_int is None else t_int[:half],
                        None if noise is None else noise[:half], **kw)
    return loss


def _altered_gradient(original):
    def apply(self, grads):
        grads = list(grads)
        grads[0] = grads[0] * 2.0
        return original(self, grads)
    return apply


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "gradient_altered", "frozen_in_window"])
def test_a_broken_training_step_reads_not_correct(spec, monkeypatch, name,
                                                  fault):
    """The training cell's whole run but the look for a card, with the
    trainer broken underneath: an optimizer that leaves the state
    unchanged; the loss of half the batch, its mean taken over the rest;
    a gradient altered where the optimizer gets it; an optimizer that
    stops updating once the window runs.  (One card: no exchange between
    cards to leave out.)"""
    from diffndm_tpu_torch.train.trainer import AmsgradState, Trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(AmsgradState, "update", _frozen_update)
    elif fault == "frozen_in_window":
        monkeypatch.setattr(AmsgradState, "update",
                            _frozen_after_setup(AmsgradState.update))
    elif fault == "half_batch":
        monkeypatch.setattr(Trainer, "_loss", _half_batch_loss(Trainer._loss))
    else:
        monkeypatch.setattr(Trainer, "apply_gradients",
                            _altered_gradient(Trainer.apply_gradients))
    run = run_tiny(_cell(spec, name), seconds=1.0)
    assert not _correct(run), run.checks
