"""TTA methods as adapter schemes (counterpart of
``longcat_video_tta_tpu/tta/adapters.py``). A scheme gives the trainable
tensors (``init``) and maps them onto what every loss and the sampler
consume (``to_forward`` -> (dit, adapters dict)). Only ``delta_a`` is
ported: one fp32 delta added to the t-embedding."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import AdapterConfig, DiTConfig
from ..models.dit import LongCatDiT

TrainParams = Dict[str, torch.Tensor]


class AdapterScheme:
    """One TTA method = init + a to_forward mapping. For adapter methods
    ``to_forward`` returns the base DiT unchanged plus the adapters."""

    method = "base"

    def __init__(self, dit_cfg: DiTConfig, acfg: AdapterConfig):
        self.cfg = dit_cfg
        self.acfg = acfg

    def init(self, device="cpu") -> TrainParams:
        raise NotImplementedError

    def to_forward(self, train_params: TrainParams,
                   dit: LongCatDiT) -> Tuple[LongCatDiT, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def num_params(self, train_params: TrainParams) -> int:
        return sum(int(x.numel()) for x in train_params.values())


class DeltaAScheme(AdapterScheme):
    """delta_a: one zero-initialised fp32 [adaln_tembed_dim] delta on the
    t-embedding of every block and of the final layer."""

    method = "delta_a"

    def init(self, device="cpu") -> TrainParams:
        return {"delta": torch.zeros((self.cfg.adaln_tembed_dim,),
                                     dtype=torch.float32, device=device)}

    def to_forward(self, train_params, dit):
        return dit, {"delta_t": train_params["delta"]}


SCHEMES = {"delta_a": DeltaAScheme}


def build_scheme(dit_cfg: DiTConfig, acfg: AdapterConfig) -> AdapterScheme:
    if acfg.method not in SCHEMES:
        raise NotImplementedError(
            f"TTA method {acfg.method!r} is not yet ported to the PyTorch port "
            f"(ported: {sorted(SCHEMES)})")
    return SCHEMES[acfg.method](dit_cfg, acfg)
