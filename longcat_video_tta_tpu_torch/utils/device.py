"""Device selection: entry points run on the card unless the caller asks
for the CPU, and a CUDA request on a machine without a GPU raises."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was requested but no CUDA GPU is "
                           "available (pass device='cpu' / --device cpu to "
                           "run on the CPU)")
    return device
