"""LPIPS with the AlexNet trunk (counterpart of
``longcat_video_tta_tpu/eval/lpips.py``).

- the trunk is torchvision's ``alexnet().features``: convs 11/4/2,
  5/1/2 and three 3/1/1, a ReLU after each (the five taps), 3x2 max
  pools in floor mode after taps 0 and 1;
- the head: the input scaling layer, each tap normalised to unit length
  over its channels (x / (||x|| + 1e-10)), the squared difference
  weighted by the non-negative 1x1 weights, the spatial mean, the sum
  over taps;
- ``convert_torch_lpips_state`` maps the ``lpips.LPIPS(net='alex')``
  state dict (``scaling_layer.shift/scale``, ``net.sliceK.<i>.*``,
  ``linK.model.1.weight``); a checkpoint without the scaling layer takes
  the published constants; a key left unread refuses the conversion.

Everything runs in fp32 (no TF32) on the module's device.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import full_fp32, resolve_device

# (kernel, stride, pad, cin, cout) for the five AlexNet convs
_CONV_SPECS = (
    (11, 4, 2, 3, 64),
    (5, 1, 2, 64, 192),
    (3, 1, 1, 192, 384),
    (3, 1, 1, 384, 256),
    (3, 1, 1, 256, 256),
)
_POOL_AFTER = (0, 1)
# the lpips package's ScalingLayer constants (in [-1, 1] space)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision alexnet.features indices of the convs inside lpips' slices
_SLICE_CONV_IDX = (("slice1", 0), ("slice2", 3), ("slice3", 6), ("slice4", 8),
                   ("slice5", 10))


class LPIPSAlex(nn.Module):
    def __init__(self):
        super().__init__()
        self.shift = nn.Parameter(torch.empty(3))
        self.scale = nn.Parameter(torch.empty(3))
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, k, stride=s, padding=p)
                                   for k, s, p, cin, cout in _CONV_SPECS)
        self.lins = nn.ParameterList(nn.Parameter(torch.empty(cout))
                                     for *_, cout in _CONV_SPECS)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, H, W, 3] in [-1, 1] -> the five post-ReLU maps (NCHW)."""
        x = ((x - self.shift) / self.scale).permute(0, 3, 1, 2)
        feats = []
        for i, conv in enumerate(self.convs):
            # a map the VALID pooling emptied stays empty, and its
            # distance is the mean of nothing (NaN), as in the reference
            x = F.relu(conv(x)) if x.numel() else x.new_zeros(
                x.shape[0], conv.out_channels, 0, 0)
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2) if min(x.shape[2:]) >= 3 else x[:, :, :0, :0]
        return feats

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] x2 in [0, 1] -> per-image distances [B]."""
        total = None
        for f1, f2, w in zip(self.features(pred.float() * 2.0 - 1.0),
                             self.features(target.float() * 2.0 - 1.0), self.lins):
            n1 = f1 / (torch.linalg.vector_norm(f1, dim=1, keepdim=True) + 1e-10)
            n2 = f2 / (torch.linalg.vector_norm(f2, dim=1, keepdim=True) + 1e-10)
            d = torch.sum((n1 - n2) ** 2 * w[None, :, None, None], dim=1)   # [B, H, W]
            layer = torch.mean(d, dim=(1, 2))
            total = layer if total is None else total + layer
        return total


def lpips_alex(model: LPIPSAlex, pred, target) -> torch.Tensor:
    """Distances [B] of [B, H, W, 3] frame pairs in [0, 1] (arrays or
    tensors), in fp32 on the model's device."""
    device = model.shift.device
    with torch.no_grad(), full_fp32():
        return model(torch.as_tensor(pred, dtype=torch.float32, device=device),
                     torch.as_tensor(target, dtype=torch.float32, device=device))


def convert_torch_lpips_state(sd, device="cpu") -> LPIPSAlex:
    """``lpips.LPIPS(net='alex').state_dict()`` -> ``LPIPSAlex``."""
    from ..models.convert import TrackedStateDict, load_mapped

    sd = TrackedStateDict(sd)
    pairs = []
    if "scaling_layer.shift" in sd:
        flat = lambda t: t.reshape(3)
        pairs += [("shift", "scaling_layer.shift", flat), ("scale", "scaling_layer.scale", flat)]
    for i, ((sl, idx), (k, _s, _p, cin, cout)) in enumerate(zip(_SLICE_CONV_IDX, _CONV_SPECS)):
        shape = tuple(sd[f"net.{sl}.{idx}.weight"].shape)
        if shape != (cout, cin, k, k):
            raise ValueError(f"net.{sl}.{idx}.weight has shape {shape}, expected "
                             f"{(cout, cin, k, k)}: not an AlexNet LPIPS checkpoint")
        pairs += [(f"convs.{i}.weight", f"net.{sl}.{idx}.weight"),
                  (f"convs.{i}.bias", f"net.{sl}.{idx}.bias"),
                  (f"lins.{i}", f"lin{i}.model.1.weight", lambda t: t.reshape(-1))]
    if "scaling_layer.shift" not in sd:  # the published constants
        pairs += [("shift", torch.tensor(_SHIFT)), ("scale", torch.tensor(_SCALE))]
    return load_mapped(LPIPSAlex, sd, pairs, "LPIPS(alex)", device)


def load_lpips_params(path: str, device="cuda") -> LPIPSAlex:
    """A saved ``lpips.LPIPS(net='alex')`` state dict (``torch.load``,
    weights only) converted onto ``device``."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_torch_lpips_state(sd, device)


def make_lpips_feature_fn(model: LPIPSAlex) -> Callable:
    """-> fn(pred [T, H, W, 3], target [T, H, W, 3] in [0, 1]) -> [T]
    numpy, the ``evaluate_generation_metrics`` / ``compute_lpips`` hook."""

    def feature_fn(pred, target) -> np.ndarray:
        return lpips_alex(model, pred, target).cpu().numpy()

    return feature_fn
