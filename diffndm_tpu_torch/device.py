"""Device selection and numeric settings shared by the entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a GPU this raises unless the caller named a device
    other than a CUDA one, so nothing falls back to the CPU silently.

    Also pins float32 matrix products and convolutions to full fp32 (no
    TF32): the JAX reference runs fp32 and the port's tolerances assume it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device
