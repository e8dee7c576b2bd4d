"""InceptionV3 (torchvision ``inception_v3``, ImageNet) frame features for
FID (counterpart of ``longcat_video_tta_tpu/eval/inception.py``).

- the ``Inception3`` eval path (``AuxLogits`` is train-time): VALID stem
  convs, 3x3 stride-2 VALID max pools, the InceptionA/B/C/D/E blocks
  whose branch pools are 3x3 stride-1 averages over a zero padding that
  counts in the divisor (9), the global mean: 2048-d features;
  ``transform_input`` (forced by torchvision's constructor with weights) is
  folded into the forward;
- BasicConv2d = conv (no bias) + inference BN, eps 1e-3, + ReLU;
- ``convert_torch_inception_state`` maps torchvision's state dict and
  ignores ``AuxLogits.*`` and ``fc.*`` (fc is replaced by Identity);
- ``preprocess_frames`` is the reference's protocol without Pillow:
  ``Image.resize(BILINEAR)`` of the uint8 frame, shorter side to 299,
  reimplemented on the host (``pil_bilinear_resize``), center crop,
  ImageNet normalisation;
- ``make_inception_feature_fn`` runs 16 frames per batch on the tower's
  device in fp32.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import full_fp32, resolve_device
from .i3d import _BN_KEYS, FrozenBN

FEATURE_DIM = 2048
_BN_EPS = 1e-3

# (name, cin, cout, (kh, kw), (sh, sw), (ph, pw)) for the stem
_STEM = (
    ("Conv2d_1a_3x3", 3, 32, (3, 3), (2, 2), (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), (1, 1), (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), (1, 1), (1, 1)),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), (1, 1), (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), (1, 1), (0, 0)),
)


# branch -> (cin, cout, kernel, pad); strides are in the block forwards
def _a_spec(cin, pool):
    return {
        "branch1x1": (cin, 64, (1, 1), (0, 0)),
        "branch5x5_1": (cin, 48, (1, 1), (0, 0)),
        "branch5x5_2": (48, 64, (5, 5), (2, 2)),
        "branch3x3dbl_1": (cin, 64, (1, 1), (0, 0)),
        "branch3x3dbl_2": (64, 96, (3, 3), (1, 1)),
        "branch3x3dbl_3": (96, 96, (3, 3), (1, 1)),
        "branch_pool": (cin, pool, (1, 1), (0, 0)),
    }


def _b_spec(cin):
    return {
        "branch3x3": (cin, 384, (3, 3), (0, 0)),
        "branch3x3dbl_1": (cin, 64, (1, 1), (0, 0)),
        "branch3x3dbl_2": (64, 96, (3, 3), (1, 1)),
        "branch3x3dbl_3": (96, 96, (3, 3), (0, 0)),
    }


def _c_spec(cin, c7):
    return {
        "branch1x1": (cin, 192, (1, 1), (0, 0)),
        "branch7x7_1": (cin, c7, (1, 1), (0, 0)),
        "branch7x7_2": (c7, c7, (1, 7), (0, 3)),
        "branch7x7_3": (c7, 192, (7, 1), (3, 0)),
        "branch7x7dbl_1": (cin, c7, (1, 1), (0, 0)),
        "branch7x7dbl_2": (c7, c7, (7, 1), (3, 0)),
        "branch7x7dbl_3": (c7, c7, (1, 7), (0, 3)),
        "branch7x7dbl_4": (c7, c7, (7, 1), (3, 0)),
        "branch7x7dbl_5": (c7, 192, (1, 7), (0, 3)),
        "branch_pool": (cin, 192, (1, 1), (0, 0)),
    }


def _d_spec(cin):
    return {
        "branch3x3_1": (cin, 192, (1, 1), (0, 0)),
        "branch3x3_2": (192, 320, (3, 3), (0, 0)),
        "branch7x7x3_1": (cin, 192, (1, 1), (0, 0)),
        "branch7x7x3_2": (192, 192, (1, 7), (0, 3)),
        "branch7x7x3_3": (192, 192, (7, 1), (3, 0)),
        "branch7x7x3_4": (192, 192, (3, 3), (0, 0)),
    }


def _e_spec(cin):
    return {
        "branch1x1": (cin, 320, (1, 1), (0, 0)),
        "branch3x3_1": (cin, 384, (1, 1), (0, 0)),
        "branch3x3_2a": (384, 384, (1, 3), (0, 1)),
        "branch3x3_2b": (384, 384, (3, 1), (1, 0)),
        "branch3x3dbl_1": (cin, 448, (1, 1), (0, 0)),
        "branch3x3dbl_2": (448, 384, (3, 3), (1, 1)),
        "branch3x3dbl_3a": (384, 384, (1, 3), (0, 1)),
        "branch3x3dbl_3b": (384, 384, (3, 1), (1, 0)),
        "branch_pool": (cin, 192, (1, 1), (0, 0)),
    }


MIXED_SPECS: Dict[str, Dict[str, Tuple]] = {
    "Mixed_5b": _a_spec(192, 32),
    "Mixed_5c": _a_spec(256, 64),
    "Mixed_5d": _a_spec(288, 64),
    "Mixed_6a": _b_spec(288),
    "Mixed_6b": _c_spec(768, 128),
    "Mixed_6c": _c_spec(768, 160),
    "Mixed_6d": _c_spec(768, 160),
    "Mixed_6e": _c_spec(768, 192),
    "Mixed_7a": _d_spec(768),
    "Mixed_7b": _e_spec(1280),
    "Mixed_7c": _e_spec(2048),
}
# the block type of each mixed block (InceptionA .. InceptionE)
MIXED_KINDS = {"Mixed_5b": "a", "Mixed_5c": "a", "Mixed_5d": "a", "Mixed_6a": "b",
               "Mixed_6b": "c", "Mixed_6c": "c", "Mixed_6d": "c", "Mixed_6e": "c",
               "Mixed_7a": "d", "Mixed_7b": "e", "Mixed_7c": "e"}


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kernel, pad):
        super().__init__()
        self.pad = tuple(pad)
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False)
        self.bn = FrozenBN(cout, _BN_EPS)

    def forward(self, x, stride=1):
        return F.relu(self.bn(F.conv2d(x, self.conv.weight, stride=stride,
                                       padding=self.pad)))


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool_same(x):
    # F.avg_pool2d counts the zero padding in the divisor (count_include_pad)
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class Mixed(nn.Module):
    """One InceptionA/B/C/D/E block; ``kind`` picks the forward."""

    def __init__(self, kind: str, spec):
        super().__init__()
        self.kind = kind
        for name, (cin, cout, k, pad) in spec.items():
            setattr(self, name, BasicConv2d(cin, cout, k, pad))

    def _chain(self, x, *names):
        for n in names:
            x = getattr(self, n)(x)
        return x

    def forward(self, x):
        if self.kind == "a":
            return torch.cat([self.branch1x1(x),
                              self._chain(x, "branch5x5_1", "branch5x5_2"),
                              self._chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                                          "branch3x3dbl_3"),
                              self.branch_pool(_avgpool_same(x))], dim=1)
        if self.kind == "b":
            b1 = self.branch3x3dbl_3(self._chain(x, "branch3x3dbl_1", "branch3x3dbl_2"),
                                     stride=2)
            return torch.cat([self.branch3x3(x, stride=2), b1, _maxpool(x)], dim=1)
        if self.kind == "c":
            return torch.cat([self.branch1x1(x),
                              self._chain(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
                              self._chain(x, "branch7x7dbl_1", "branch7x7dbl_2",
                                          "branch7x7dbl_3", "branch7x7dbl_4",
                                          "branch7x7dbl_5"),
                              self.branch_pool(_avgpool_same(x))], dim=1)
        if self.kind == "d":
            b0 = self.branch3x3_2(self.branch3x3_1(x), stride=2)
            b1 = self.branch7x7x3_4(self._chain(x, "branch7x7x3_1", "branch7x7x3_2",
                                                "branch7x7x3_3"), stride=2)
            return torch.cat([b0, b1, _maxpool(x)], dim=1)
        b1 = self.branch3x3_1(x)
        b2 = self._chain(x, "branch3x3dbl_1", "branch3x3dbl_2")
        return torch.cat([self.branch1x1(x),
                          self.branch3x3_2a(b1), self.branch3x3_2b(b1),
                          self.branch3x3dbl_3a(b2), self.branch3x3dbl_3b(b2),
                          self.branch_pool(_avgpool_same(x))], dim=1)


class InceptionV3(nn.Module):
    def __init__(self):
        super().__init__()
        for name, cin, cout, k, _s, pad in _STEM:
            setattr(self, name, BasicConv2d(cin, cout, k, pad))
        for name, spec in MIXED_SPECS.items():
            setattr(self, name, Mixed(MIXED_KINDS[name], spec))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] ImageNet-normalised -> [B, 2048]; H, W >= 75."""
        scale = torch.tensor([0.229, 0.224, 0.225], device=images.device) / 0.5
        shift = (torch.tensor([0.485, 0.456, 0.406], device=images.device) - 0.5) / 0.5
        x = (images * scale + shift).permute(0, 3, 1, 2)   # transform_input
        x = self.Conv2d_1a_3x3(x, stride=2)
        x = _maxpool(self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(x)))
        x = _maxpool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in MIXED_SPECS:
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))


def inception_features(model: InceptionV3, images) -> torch.Tensor:
    """[B, H, W, 3] normalised (array or tensor) -> [B, 2048] in fp32 on
    the model's device."""
    device = model.Conv2d_1a_3x3.conv.weight.device
    with torch.no_grad(), full_fp32():
        return model(torch.as_tensor(images, dtype=torch.float32, device=device))


def convert_torch_inception_state(sd, device="cpu") -> InceptionV3:
    """A torchvision ``inception_v3`` state dict -> ``InceptionV3``
    (``AuxLogits.*`` and ``fc.*`` ignored)."""
    from ..models.convert import TrackedStateDict, load_mapped

    sd = TrackedStateDict(sd)
    sd.ignore(lambda k: k.startswith(("AuxLogits.", "fc."))
              or k.endswith("num_batches_tracked"))
    units = [name for name, *_ in _STEM] + [f"{m}.{b}" for m, spec in MIXED_SPECS.items()
                                            for b in spec]
    pairs = []
    for u in units:
        pairs += [(f"{u}.conv.weight",) * 2] + [(f"{u}.bn.{k}",) * 2 for k in _BN_KEYS]
    return load_mapped(InceptionV3, sd, pairs, "InceptionV3", device)


def load_inception_params(path: str, device="cuda") -> InceptionV3:
    """InceptionV3 weights from a ``.pth``/``.bin`` state dict, a
    ``.safetensors`` file of the same names, or a folder holding one of
    ``inception_v3.pth``, ``pytorch_model.bin``, ``model.safetensors``."""
    from ..utils.safetensors import load_file

    device = resolve_device(device)
    if os.path.isdir(path):
        for cand in ("inception_v3.pth", "pytorch_model.bin", "model.safetensors"):
            if os.path.exists(os.path.join(path, cand)):
                path = os.path.join(path, cand)
                break
    if path.endswith(".safetensors"):
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_inception_state(sd, device)


# ---------------------------------------------------------------------------
# Pillow's bilinear resize of uint8 images, without Pillow
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """(first input index [out], int32 coefficients [out, ksize]) of one
    axis, as Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``
    make them: a triangle filter whose support scales with the downscale
    factor, each row normalised in double precision, then rounded to
    22-bit fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    coeffs = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)       # C casts truncate
        hi = min(int(center + support + 0.5), in_size)
        ss = 1.0 / filterscale
        ws = []
        for x in range(hi - lo):
            t = abs((x + lo - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for w in ws:  # summed in order, as the C loop does
            ww += w
        for x, w in enumerate(ws):
            w = w / ww if ww != 0.0 else w
            coeffs[xx, x] = int(w * (1 << _PRECISION_BITS) + (0.5 if w >= 0 else -0.5))
        first[xx] = lo
    return first, coeffs


def _pil_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One fixed-point pass along ``axis`` of a uint8 array: the sum of
    the taps from 1 << 21, shifted right by 22, clamped to [0, 255]."""
    first, coeffs = _pil_bilinear_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, -1).astype(np.int32)
    acc = np.full(src.shape[:-1] + (out_size,), 1 << (_PRECISION_BITS - 1), np.int32)
    last = img.shape[axis] - 1
    for k in range(coeffs.shape[1]):
        acc += src[..., np.minimum(first + k, last)] * coeffs[:, k]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def pil_bilinear_resize(frames: np.ndarray, width: int, height: int) -> np.ndarray:
    """[T, H, W, C] uint8 -> [T, height, width, C] uint8, equal to
    ``Image.resize((width, height), Image.BILINEAR)`` per frame: the
    horizontal pass first, each pass rounded back to uint8."""
    out = frames
    if width != frames.shape[2]:
        out = _pil_pass(out, 2, width)
    if height != frames.shape[1]:
        out = _pil_pass(out, 1, height)
    return out


def preprocess_frames(frames: np.ndarray, size: int = 299) -> np.ndarray:
    """[T, H, W, 3] in [0, 1] -> [T, size, size, 3] ImageNet-normalised:
    uint8 (truncated), bilinear resize of the shorter side to ``size``,
    center crop, normalise."""
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    img = (np.clip(np.asarray(frames), 0.0, 1.0) * 255).astype(np.uint8)
    h, w = img.shape[1:3]
    if w <= h:
        nw, nh = size, max(size, int(round(size * h / w)))
    else:
        nw, nh = max(size, int(round(size * w / h))), size
    img = pil_bilinear_resize(img, nw, nh)
    left, top = (nw - size) // 2, (nh - size) // 2
    arr = img[:, top:top + size, left:left + size].astype(np.float32) / 255.0
    return (arr - mean) / std


def make_inception_feature_fn(model: InceptionV3, batch: int = 16) -> Callable:
    """-> the accumulator's ``frame_feature_fn``: [T, H, W, 3] in [0, 1]
    -> [T, 2048] float64, ``batch`` frames per call on the device."""

    def feat(frames: np.ndarray) -> np.ndarray:
        x = preprocess_frames(np.asarray(frames))
        outs = [inception_features(model, x[i:i + batch]).cpu().numpy()
                for i in range(0, x.shape[0], batch)]
        return np.concatenate(outs).astype(np.float64)

    return feat
