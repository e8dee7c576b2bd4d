"""Each backbone's pieces in one record, looked up by name: the
``arch`` of a DiT config (``ModelConfig.arch`` reads it). A backbone's
record holds its DiT module and fill, its loaders from a reference tree
and from a ``dit/`` shard folder, its W8A8 decode copy, its (loss,
anchor) pair and the TTA schemes ported to it. A new backbone adds one
record here."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict


@dataclass(frozen=True)
class Arch:
    dit_cls: type
    fill: Callable             # (empty DiT, Getter) -> None
    from_numpy: Callable       # (reference tree, dit cfg, device) -> DiT
    from_checkpoint: Callable  # (dit/ folder, dit cfg, device, mesh=) -> DiT
    quantize: Callable         # DiT -> its W8A8 decode copy
    loss: Callable             # the conditioned flow-matching loss
    anchor: Callable           # its fixed-draw version (the anchor)
    schemes: Dict[str, type]   # method -> AdapterScheme class


@functools.lru_cache(maxsize=None)
def _archs() -> Dict[str, Arch]:
    # built on first use: the modules below import one another
    from .models import convert, weights
    from .models.cogvideox import CogVideoX
    from .models.dit import LongCatDiT
    from .models.mmdit import MMDiT
    from .ops import quant
    from .tta import adapters, losses

    return {
        "longcat": Arch(LongCatDiT, weights._fill_dit, weights.load_dit_from_numpy,
                        convert.load_dit_checkpoint, quant.quantize_dit_blocks_int8,
                        losses.flow_matching_loss_conditioned,
                        losses.flow_matching_loss_conditioned_fixed, adapters.SCHEMES),
        "mmdit": Arch(MMDiT, weights._fill_mmdit, weights.load_mmdit_from_numpy,
                      convert.load_mmdit_checkpoint, quant.quantize_mmdit_blocks_int8,
                      losses.mmdit_flow_matching_loss_conditioned,
                      losses.mmdit_flow_matching_loss_conditioned_fixed,
                      adapters.MMDIT_SCHEMES),
        "cogvideox": Arch(CogVideoX, weights._fill_cogvideox,
                          weights.load_cogvideox_from_numpy,
                          convert.load_cogvideox_checkpoint,
                          quant.quantize_cogvideox_blocks_int8,
                          losses.cogvideox_flow_matching_loss_conditioned,
                          losses.cogvideox_flow_matching_loss_conditioned_fixed,
                          adapters.COGVIDEOX_SCHEMES),
    }


def get_arch(name: str) -> Arch:
    return _archs()[name]
