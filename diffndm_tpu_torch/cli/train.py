"""Train the pocket-conditional model from a YAML config (the JAX
package's ``cli/train.py``), on the GPU unless ``--device cpu``.

- ``--resume <checkpoint.npz>`` loads params, step and EMA weights (no
  optimizer state: the optimizer starts fresh, as in JAX) and merges the
  ``hparams.yaml`` beside the checkpoint over the given config (the
  checkpoint's values win, with a line per overwrite; paths and the
  eval / epoch cadence follow the current invocation);
- ``--set KEY=VALUE`` (dotted keys reach nested mappings) applies after
  the merge; values are read as YAML scalars;
- with ``diffusion_noise_schedule: learned`` (and the ``vlb`` loss) the
  schedule's gamma network trains with the denoiser and checkpoints
  beside it;
- every ``eval_epochs`` epochs: the validation loss (VLB), then ligands
  sampled from the EMA weights for the first validation pocket batch and
  scored by the chemistry dashboard, all in ``metrics.jsonl``; ``best``
  (lowest validation loss) and ``last`` checkpoints (``.npz``) and the
  run's ``hparams.yaml`` go to ``<logdir>/<run_name>``.

Data parallelism, as the JAX CLI trains over ``make_mesh()`` of every
local device: with ``--device cuda`` and more than one visible card it
runs one process per card (``CUDA_VISIBLE_DEVICES`` narrows the set)
over NCCL, the kernels built once before the ranks start; started by
``torchrun`` it joins the group torchrun describes (NCCL on the cards,
gloo with ``--device cpu``).  Every rank iterates the same loader order
and the trainer pads and splits each global batch (``Trainer(...,
group=...)``).  Rank 0 alone writes the run's files and samples the
dashboard while the other ranks wait.  On one card it is one process, as
before.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# how long a rank waits in a collective (the others may be sampling the
# dashboard or writing checkpoints meanwhile)
COLLECTIVE_TIMEOUT = 3600.0


def merge_resume_hparams(raw: dict, resume: str) -> dict:
    """The ``hparams.yaml`` beside ``resume`` (or inside it, for a
    directory) merged over ``raw``; every overwritten key prints a line."""
    from diffndm_tpu_torch.config import load_yaml

    hp_path = os.path.join(os.path.dirname(os.path.abspath(resume)),
                           "hparams.yaml")
    if not os.path.exists(hp_path):
        hp_path = os.path.join(resume, "hparams.yaml")
    if not os.path.exists(hp_path):
        print(f"[resume] no hparams.yaml next to {resume}; using the passed "
              f"config as-is")
        return raw
    saved = load_yaml(hp_path)
    merged = dict(raw)
    for k, v in saved.items():
        if k in ("datadir", "logdir", "run_name", "eval_epochs", "n_epochs"):
            continue    # paths and the run's cadence follow this invocation
        if k in merged and merged[k] != v:
            print(f"[resume] config value {k}={merged[k]!r} overwritten by "
                  f"checkpoint value {v!r}")
        merged[k] = v
    return merged


def apply_overrides(raw: dict, overrides, error) -> dict:
    """``KEY=VALUE`` overrides (dotted keys reach nested mappings), each
    value read as a YAML scalar; ``error`` is called on a malformed one."""
    from diffndm_tpu_torch.config import _scalar

    for ov in overrides:
        k, eq, v = ov.partition("=")
        if not eq:
            error(f"--set expects KEY=VALUE, got {ov!r}")
        cur, parts = raw, k.split(".")
        for pk in parts[:-1]:
            nxt = cur.setdefault(pk, {})
            if not isinstance(nxt, dict):
                error(f"--set {k}: {pk!r} is not a mapping")
            cur = nxt
        if parts[-1] not in cur:
            print(f"[override] WARNING: {k!r} was not present in the merged "
                  f"hparams — check for a typo")
        cur[parts[-1]] = _scalar(v)
        print(f"[override] {k} = {cur[parts[-1]]!r}")
    return raw


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--resume", type=str, default=None,
                   help="training checkpoint (.npz) to resume from")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_seconds", type=float, default=None,
                   help="wall-clock budget; stops after the current epoch")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="hparam override applied after the resume merge; "
                        "repeatable")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict:
    p = parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    import torch

    from diffndm_tpu_torch.device import resolve_device
    from diffndm_tpu_torch.parallel import mesh

    device = resolve_device(args.device)
    if mesh.launched_by_torchrun():
        group = mesh.init_data_group(
            "nccl" if device.type == "cuda" else "gloo",
            timeout=COLLECTIVE_TIMEOUT)
        try:
            return run(args, group.device, group, p.error)
        finally:
            mesh.close(group)
    world = (torch.cuda.device_count()
             if device.type == "cuda" and device.index is None else 1)
    if world == 1:
        return run(args, device, None, p.error)
    from diffndm_tpu_torch.ops import egnn_kernels as K

    K.build_library()
    K.build_library(source=K.BWD_SOURCE)
    print(f"[train] data-parallel over {world} cards (NCCL)")
    return mesh.spawn(_train_rank, world, "nccl", args=(argv,),
                      timeout=None,
                      collective_timeout=COLLECTIVE_TIMEOUT)[0]


def _train_rank(group, argv) -> dict:
    """One rank of a run ``main`` spawned."""
    p = parser()
    return run(p.parse_args(argv), group.device, group, p.error)


def run(args, device, group, error) -> dict:
    """The training run of one process: the whole run, or a rank's part
    of a data-parallel one (``group``)."""
    import numpy as np
    import torch

    from diffndm_tpu_torch.config import (dump_yaml, load_yaml,
                                          model_config_from_yaml,
                                          train_config_from_yaml)
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.data.dataset import (BucketedLoader,
                                                ProcessedLigandPocketDataset)
    from diffndm_tpu_torch.device import resolve_device
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.parallel import mesh
    from diffndm_tpu_torch.train.eval_dashboard import ChemistryDashboard
    from diffndm_tpu_torch.train.metrics_logger import MetricsLogger
    from diffndm_tpu_torch.train.trainer import Trainer

    device = resolve_device(device)     # also in a spawned rank
    lead = group is None or group.rank == 0
    if group is not None and device.type == "cuda":
        # one build for the group (a cached build is found at once)
        if lead:
            from diffndm_tpu_torch.ops import egnn_kernels as K

            K.build_library()
            K.build_library(source=K.BWD_SOURCE)
        mesh.barrier(group)
    raw = load_yaml(args.config)
    if args.resume:
        raw = merge_resume_hparams(raw, args.resume)
    apply_overrides(raw, args.overrides, error)
    mcfg = model_config_from_yaml(raw)
    tcfg = train_config_from_yaml(raw)
    datadir = raw["datadir"]
    outdir = os.path.join(raw.get("logdir", "runs"),
                          raw.get("run_name", "run"))
    if lead:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "hparams.yaml"), "w") as f:
            f.write(dump_yaml(raw))
        logger = MetricsLogger(outdir)

    hist_path = os.path.join(datadir, "size_distribution.npy")
    hist = np.load(hist_path) if os.path.exists(hist_path) else None
    model = DiffNDM(mcfg, size_histogram=hist, device=device)
    di = dataset_params[mcfg.dataset]
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    # a learned schedule's gamma network trains with the dynamics (VLB)
    trainer = Trainer(model.core, model.dynamics, tcfg,
                      lj_rm=di["lennard_jones_rm"], generator=generator,
                      gamma=model.gamma, group=group)
    if args.resume:
        trainer.load_checkpoint(args.resume)

    train_ds = ProcessedLigandPocketDataset(
        os.path.join(datadir, "train.npz"))
    val_path = os.path.join(datadir, "val.npz")
    val_ds = (ProcessedLigandPocketDataset(val_path)
              if os.path.exists(val_path) else None)
    drop = di["_pad_types"]
    loader = BucketedLoader(train_ds, tcfg.batch_size,
                            drop_feature_cols=drop)
    smiles_path = os.path.join(datadir, "train_smiles.npy")
    train_smiles = (np.load(smiles_path, allow_pickle=True).tolist()
                    if os.path.exists(smiles_path) else None)
    eval_params = raw.get("eval_params") or {}
    if lead:
        # the eval samples from a second model that holds the EMA weights
        eval_model = DiffNDM(mcfg, size_histogram=hist, device=device)
        dashboard = ChemistryDashboard(
            di, os.path.join(outdir, "eval"), train_smiles=train_smiles,
            n_visualize=int(eval_params.get("n_visualize_samples", 0)),
            receptor_pdb=eval_params.get("receptor_pdb"))

    step, best_val, n_evals = 0, float("inf"), 0
    train_losses, val_losses = [], []
    t_start = time.time()
    stop = False
    for epoch in range(tcfg.n_epochs):
        t0 = time.time()
        losses, info = [], {}
        for ligand, pocket in loader:
            loss, info = trainer.train_step(ligand, pocket)
            losses.append(loss)
            step += 1
            if args.max_steps and step >= args.max_steps:
                stop = True
                break
        train_losses.extend(losses)
        if lead:
            logger.log({"loss": float(np.mean(losses)),
                        "grad_norm": info.get("grad_norm", 0.0),
                        "epoch_seconds": time.time() - t0,
                        "steps": len(losses)}, step, epoch, "train")
        if val_ds is not None and (epoch + 1) % tcfg.eval_epochs == 0:
            val_loader = BucketedLoader(val_ds, tcfg.batch_size,
                                        shuffle=False,
                                        drop_feature_cols=drop)
            vl, first_pocket = [], None
            for ligand, pocket in val_loader:
                if first_pocket is None:
                    first_pocket = pocket
                vl.append(trainer.eval_step(ligand, pocket)[0])
            v = float(np.mean(vl))
            val_losses.append(v)
            metrics = {"loss": v}
            if first_pocket is not None and lead:
                # sample from the EMA weights (the raw ones without EMA),
                # a learned schedule's included
                eval_model.set_params(trainer.ema_state_dict(),
                                      trainer.gamma_ema_state_dict() or None)
                metrics.update(dashboard.sample_and_analyze(
                    eval_model, first_pocket.to(device), epoch=epoch,
                    dump_sdf=True, seed=tcfg.seed + n_evals))
            n_evals += first_pocket is not None
            if lead:
                logger.log(metrics, step, epoch, "val")
            if group is not None:
                mesh.barrier(group)     # the others wait for the dashboard
            if v < best_val:
                best_val = v
                trainer.save_checkpoint(os.path.join(outdir, "best.npz"))
        trainer.save_checkpoint(os.path.join(outdir, "last.npz"))
        over = bool(args.max_seconds
                    and time.time() - t_start > args.max_seconds)
        if group is not None:
            over = mesh.rank0_flag(group, over)     # rank 0's clock decides
        if over:
            print(f"[train] wall-clock budget reached ({args.max_seconds}s);"
                  f" stopping")
            stop = True
        if stop:
            break
    if lead:
        logger.close()
    print("training done")
    return {"steps": step, "train_losses": train_losses,
            "val_losses": val_losses, "best_val": best_val,
            "outdir": outdir}


if __name__ == "__main__":
    main()
