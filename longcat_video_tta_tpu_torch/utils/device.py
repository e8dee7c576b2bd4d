"""Device selection: entry points run on the card unless the caller asks
for the CPU, and a CUDA request on a machine without a GPU raises.
``full_fp32`` runs a scope's fp32 products and convolutions in full fp32,
whatever the process's TF32 settings."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was requested but no CUDA GPU is "
                           "available (pass device='cpu' / --device cpu to "
                           "run on the CPU)")
    return device


@contextlib.contextmanager
def full_fp32():
    """No TF32 inside the scope: cuBLAS matmuls and cuDNN convolutions of
    fp32 tensors keep their 23-bit mantissa (PyTorch lets cuDNN use TF32
    by default). The previous settings come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = old
