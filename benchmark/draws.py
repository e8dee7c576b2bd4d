"""Everything a run draws comes from ``--seed`` through here: one
``torch.Generator`` per (seed, purpose, index), made on the device, so the
same seed gives the same weights and inputs, and two purposes never share
a stream."""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Tuple

import torch
from torch import nn


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for (seed, *tags); any whole ``seed``, however large."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def normal(shape, gen: torch.Generator, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


# parameter name -> ("normal", std) | ("ones", 0) | ("zeros", 0)
Rule = Callable[[str], Tuple[str, float]]


def draw_weights(module: nn.Module, rule: Rule, gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """Give a module built on the meta device its weights: the parameters
    are grouped by (dtype, rule), each group is one flat tensor drawn or
    filled in one call in the dtype it is served in, and every parameter
    becomes a view of its group's tensor. Returns name -> tensor (the
    same storage), the weights the reference reads."""
    groups: Dict[tuple, list] = {}
    for name, p in module.named_parameters():
        groups.setdefault((p.dtype,) + tuple(rule(name)), []).append((name, p))
    weights = {}
    for (dtype, kind, std), items in groups.items():
        flat = torch.empty(sum(p.numel() for _, p in items), dtype=dtype, device=device)
        if kind == "normal":
            flat.normal_(0.0, std, generator=gen)
        elif kind == "ones":
            flat.fill_(1.0)
        else:
            flat.zero_()
        off = 0
        for name, p in items:
            view = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
            parent, _, leaf = name.rpartition(".")
            owner = module.get_submodule(parent) if parent else module
            owner._parameters[leaf] = nn.Parameter(view, requires_grad=False)
            weights[name] = view
    return weights
