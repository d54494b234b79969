"""DiffNDM in PyTorch for NVIDIA Hopper.

Pocket-conditional E(3)-equivariant diffusion over ligand + pocket point
clouds, written in PyTorch, with the EGNN edge chain in hand-written CUDA
kernels for ``sm_90a`` (``csrc/egnn_edge.cu``).  It mirrors the module
layout of the JAX package ``diffndm_tpu`` (the reference) and imports
nothing from it: weights cross over as a numpy export
(``assets/virtual_cond_v3b_ema.npz``) read by ``convert.params_from_jax``.

Entry point: ``model.DiffNDM``.  It runs on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel is replaced by its plain
PyTorch version.
"""
