"""Export the raw training state of the v3b run for the PyTorch port.

Reads the orbax checkpoint ``examples/checkpoints/virtual_cond_v3b/last``
(params, step and ema_params; it holds no optimizer state) with the JAX
package and writes it as one ``.npz`` with the tree's flat '/'-joined key
names (``params/params/...``, ``ema_params/params/...``, ``step``), the
format of the port's training checkpoints, so that
``python -m diffndm_tpu_torch.cli.train --resume <file>`` resumes v3b's
training.  Needs JAX, flax and orbax; the port never runs it.

    PYTHONPATH=. python scripts/export_v3b_train_state.py \\
        [--out diffndm_tpu_torch/assets/virtual_cond_v3b_last.npz]
"""

from __future__ import annotations

import argparse
import os

RUN = "examples/checkpoints/virtual_cond_v3b"


def restore(run: str = RUN) -> dict:
    """The orbax ``last`` payload of ``run`` as a flat {key: array}."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import orbax.checkpoint as ocp

    from diffndm_tpu import config as jcfg
    from diffndm_tpu.models.dynamics import EGNNDynamics

    mcfg = jcfg.model_config_from_yaml(
        jcfg.load_yaml(os.path.join(run, "hparams.yaml")))
    module = EGNNDynamics(mcfg.egnn, atom_nf=mcfg.atom_nf,
                          residue_nf=mcfg.residue_nf)
    # the tree's shapes suffice as the restore target
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 3 + mcfg.atom_nf)),
                            jnp.zeros((1, 16, 3 + mcfg.residue_nf)),
                            jnp.zeros((1,)), jnp.ones((1, 8)),
                            jnp.ones((1, 16)))
    restored = ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(run, "last")),
        {"params": shapes, "step": 0, "ema_params": shapes})
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                {"params": restored["params"],
                 "ema_params": restored["ema_params"]})[0]}
    flat["step"] = np.asarray(restored["step"], dtype=np.int32)
    return flat


def main(argv=None) -> None:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", default=RUN)
    p.add_argument("--out",
                   default="diffndm_tpu_torch/assets/virtual_cond_v3b_last.npz")
    args = p.parse_args(argv)
    flat = restore(args.run)
    np.savez_compressed(args.out, **flat)
    print(f"wrote {args.out}: {len(flat)} arrays, step {int(flat['step'])}")


if __name__ == "__main__":
    main()
