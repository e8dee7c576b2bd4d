"""Inception-I3D (Kinetics-400) video features for FVD (counterpart of
``longcat_video_tta_tpu/eval/i3d.py``).

- the pytorch-i3d ``InceptionI3d`` trunk: a Unit3D stem (7x7x7 stride 2
  conv + BN + ReLU), TF-SAME max pools, nine Inception modules (branch 0
  1x1x1; branches 1 and 2 1x1x1 -> 3x3x3; branch 3 a 3x3x3 max pool ->
  1x1x1; ``INCEPTION_TABLE``), a VALID 2x7x7 average pool, the 1x1x1
  logits conv and the mean over time: 400-d pre-softmax logits, the FVD
  feature;
- TF-SAME padding is asymmetric (the extra row goes after): zeros before
  each convolution, -inf before each max pool, through ``F.pad``;
- BatchNorm in inference form from the running statistics, eps 1e-3;
- ``convert_torch_i3d_state`` maps the pytorch-i3d state dict (the
  layout inside the DFoT TorchScript file: ``<unit>.conv3d.weight``,
  ``<unit>.bn.{weight,bias,running_mean,running_var}``); a key left
  unread refuses the conversion, and a file that does not convert raises
  (there is no fallback to running the TorchScript);
- ``make_i3d_feature_fn``: the accumulator's hook with the DFoT protocol
  (224 center crop, symmetric pad to >= 9 frames, [-1, 1]) on the host,
  the tower on its device in fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import full_fp32, resolve_device
from .frechet import center_crop, pad_for_i3d

# (branch0, b1_reduce, b1_out, b2_reduce, b2_out, b3_out) per module
INCEPTION_TABLE: Dict[str, Tuple[int, ...]] = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
_MODULE_IN = {
    "Mixed_3b": 192, "Mixed_3c": 256, "Mixed_4b": 480, "Mixed_4c": 512,
    "Mixed_4d": 512, "Mixed_4e": 512, "Mixed_4f": 528, "Mixed_5b": 832,
    "Mixed_5c": 832,
}
NUM_CLASSES = 400
_BN_EPS = 1e-3
_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def same_pads(sizes, kernel, stride):
    """``F.pad`` amounts (last axis first) of TF-SAME padding."""
    pads = []
    for n, k, s in reversed(list(zip(sizes, kernel, stride))):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


class FrozenBN(nn.Module):
    """Inference BatchNorm: (y - mean) * rsqrt(var + eps) * weight + bias."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        for name in _BN_KEYS:
            setattr(self, name, nn.Parameter(torch.empty(channels)))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        view = (1, -1) + (1,) * (y.ndim - 2)
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((y - self.running_mean.view(view)) * inv.view(view) * self.weight.view(view)
                + self.bias.view(view))


class Unit3D(nn.Module):
    """TF-SAME conv3d (no bias) + inference BN + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1, 1)):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=False)
        self.bn = FrozenBN(cout, _BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.stride))
        return F.relu(self.bn(F.conv3d(x, self.conv3d.weight, stride=self.stride)))


def maxpool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class InceptionModule(nn.Module):
    def __init__(self, cin: int, spec):
        super().__init__()
        b0, b1r, b1o, b2r, b2o, b3o = spec
        one, three = (1, 1, 1), (3, 3, 3)
        self.b0 = Unit3D(cin, b0, one)
        self.b1a, self.b1b = Unit3D(cin, b1r, one), Unit3D(b1r, b1o, three)
        self.b2a, self.b2b = Unit3D(cin, b2r, one), Unit3D(b2r, b2o, three)
        self.b3b = Unit3D(cin, b3o, one)

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(maxpool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64, (1, 1, 1))
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, spec in INCEPTION_TABLE.items():
            setattr(self, name, InceptionModule(_MODULE_IN[name], spec))
        self.logits = nn.ModuleDict({"conv3d": nn.Conv3d(1024, NUM_CLASSES, 1)})

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, H, W, 3] in [-1, 1] -> logits [B, 400]; T >= 9,
        H, W >= 112."""
        x = self.Conv3d_1a_7x7(video.permute(0, 4, 1, 2, 3))
        x = maxpool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = maxpool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = maxpool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = maxpool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        x = self.logits.conv3d(x)
        return torch.mean(x, dim=(2, 3, 4))


def i3d_logits(model: InceptionI3d, video) -> torch.Tensor:
    """[B, T, H, W, 3] in [-1, 1] (array or tensor) -> [B, 400] in fp32 on
    the model's device."""
    device = model.logits.conv3d.weight.device
    with torch.no_grad(), full_fp32():
        return model(torch.as_tensor(video, dtype=torch.float32, device=device))


def _unit_pairs(prefix: str):
    return ([(f"{prefix}.conv3d.weight",) * 2]
            + [(f"{prefix}.bn.{k}",) * 2 for k in _BN_KEYS])


def convert_torch_i3d_state(sd, device="cpu") -> InceptionI3d:
    """A pytorch-i3d ``InceptionI3d`` state dict -> ``InceptionI3d``."""
    from ..models.convert import TrackedStateDict, load_mapped

    sd = TrackedStateDict(sd)
    sd.ignore(lambda k: k.endswith("num_batches_tracked"))
    pairs = []
    for unit in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        pairs += _unit_pairs(unit)
    for name in INCEPTION_TABLE:
        for b in _BRANCHES:
            pairs += _unit_pairs(f"{name}.{b}")
    pairs += [("logits.conv3d.weight",) * 2, ("logits.conv3d.bias",) * 2]
    return load_mapped(InceptionI3d, sd, pairs, "InceptionI3d", device)


def load_i3d_params(path: str, device="cuda") -> InceptionI3d:
    """I3D weights from a plain state-dict file or a TorchScript archive
    (the DFoT ``i3d_torchscript.pt``: its ``state_dict()``), converted
    onto ``device``."""
    device = resolve_device(device)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except RuntimeError:  # weights_only refuses a TorchScript archive
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    return convert_torch_i3d_state(sd, device)


def make_i3d_feature_fn(model: InceptionI3d) -> Callable:
    """-> the accumulator's ``video_feature_fn``: [T, H, W, 3] in [0, 1]
    -> [400] numpy."""

    def feat(frames: np.ndarray) -> np.ndarray:
        x = pad_for_i3d(center_crop(np.asarray(frames)))
        x = np.asarray(x, np.float32)[None] * 2.0 - 1.0
        return i3d_logits(model, x).cpu().numpy().reshape(-1)

    return feat
