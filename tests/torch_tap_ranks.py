"""The rank function of ``test_torch_fanout_tap.py``'s data-parallel frame
tap: ``parallel.mesh.spawn`` runs it in new processes, which import this
module by name; like ``torch_dp_ranks`` it imports torch, numpy and the
port only.  ``group=None`` runs the same code in one process."""

import os

import torch

from torch_dp_ranks import _batch, _core, _dynamics


def tap_rank(group, spec):
    """An unguided ``sample_given_pocket`` of the global pocket batch under
    spec's fixed noise with the SDF frame tap writing to ``spec["out"]``;
    returns the files there as this rank sees them after the run, and the
    files this rank wrote."""
    torch.set_num_threads(1)
    from diffndm_tpu_torch.chem import io
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.diffusion.sampler import (ConditionalSampler,
                                                     SamplerNoise,
                                                     make_sdf_frame_tap)

    wrote, write_sdf = [], io.write_sdf
    io.write_sdf = lambda path, mols: (wrote.append(os.path.basename(path)),
                                       write_sdf(path, mols))
    core = _core(spec["T"])
    sampler = ConditionalSampler(core, _dynamics(spec["egnn"],
                                                 spec["state"]),
                                 SampleConfig(), group=group)
    sampler.set_frame_tap(make_sdf_frame_tap(
        spec["out"], dataset_params["crossdock_full"], core,
        every=spec["every"], group=group))
    noise = SamplerNoise(*(torch.from_numpy(spec["noise"][k])
                           for k in ("init", "steps", "decode")))
    sampler.sample_given_pocket(_batch(spec["pocket"]), spec["sizes"],
                                timesteps=spec["T"], noise=noise)
    if group is not None:
        from diffndm_tpu_torch.parallel.mesh import barrier

        barrier(group)
    io.write_sdf = write_sdf
    return sorted(os.listdir(spec["out"])), wrote
