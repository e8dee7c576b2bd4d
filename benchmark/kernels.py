"""The work of the attention kernels and of the model's products, and the
least time the card could take for it.

``allowed_pairs``, ``bound_s``, ``bwd_bound_s``, ``bsa_pairs`` and
``bsa_bound_s`` are frozen copies of the per-launch operation and byte
counts the repository's kernel gates use (``chip_smoke.py``:
``_allowed_pairs``, ``_bound_ms``, ``_bwd_bound_ms``, ``bsa_pairs``,
``bsa_bound_ms``), in seconds and with the card's peaks passed in.
The least time of a launch is the larger of its operations over the
peak rate and its bytes (each input read once, each output written once)
over the memory bandwidth.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def card_peaks(name: str) -> Dict[str, float]:
    """The published peaks of the card named ``name``; a card not in
    ``peaks.json`` fails the run."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    if name not in table:
        raise RuntimeError(f"no published peaks for {name!r} in {PEAKS_FILE} "
                           f"(known: {sorted(table)})")
    return table[name]


class Launch(NamedTuple):
    """One attention kernel launch: ``kernel`` is "flash_fwd",
    "flash_bwd_dq", "flash_bwd_dkv" or "bsa_fwd"; q [B, Sq, H, D] against
    k, v [B, Sk, H, D], the first ``ncond`` tokens a prefix, keys at and
    past ``kv_valid`` masked; ``pairs`` given for a block-sparse launch."""

    kernel: str
    B: int
    H: int
    Sq: int
    Sk: int
    D: int
    ncond: int = 0
    kv_valid: Optional[int] = None
    elem_bytes: int = 2
    pairs: Optional[int] = None


@dataclass
class Work:
    """The work of a unit (a train step, an anchor, a denoising step, a
    conditioning cache): product FLOPs at the 16-bit rate, W8A8 product
    operations at the int8 rate, and the attention launches."""

    flops: float = 0.0
    int8_ops: float = 0.0
    launches: List[Launch] = field(default_factory=list)

    def __iadd__(self, other: "Work") -> "Work":
        self.flops += other.flops
        self.int8_ops += other.int8_ops
        self.launches += other.launches
        return self

    def attention_flops(self) -> float:
        per_pair = {"flash_fwd": 4, "bsa_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
        return sum(per_pair[l.kernel] * l.B * l.H * l.D * launch_pairs(l)
                   for l in self.launches)


def allowed_pairs(Sq: int, Sk: int, ncond: int, kv_valid=None, q_offset: int = 0,
                  k_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through: the work this input needs.
    Queries sit at global indices q_offset.., keys at k_offset.. (a ring
    chunk); the prefix rule applies to square inputs, the key bound
    ``kv_valid`` to global key indices."""
    clamp = lambda x, hi: max(0, min(x, hi))
    kv = Sk + k_offset if kv_valid is None else kv_valid
    n_keys = clamp(kv - k_offset, Sk)
    pairs = Sq * n_keys
    if ncond > 0 and Sq == Sk:
        cond_rows = clamp(ncond - q_offset, Sq)
        cond_keys = clamp(min(ncond, kv) - k_offset, Sk)
        pairs -= cond_rows * (n_keys - cond_keys)
    return pairs


def launch_pairs(l: Launch) -> int:
    return l.pairs if l.pairs is not None else allowed_pairs(l.Sq, l.Sk, l.ncond, l.kv_valid)


def bound_s(B, H, Sq, Sk, D, ncond, kv_valid, elem_bytes, peaks) -> float:
    flops = 4.0 * B * H * D * allowed_pairs(Sq, Sk, ncond, kv_valid)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem_bytes + B * Sq * H * 4
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def bwd_bound_s(B, H, Sq, Sk, D, ncond, kv_valid, elem_bytes, dkv: bool, peaks) -> float:
    """Least time of one backward kernel: 8*D FLOP per allowed pair for
    dK/dV (S, dP, dV, dK), 6*D for dQ (S, dP, dQ); bytes: q, k, v, dO and
    the fp32 lse and delta read once, dq (or dk and dv) written once."""
    flops = (8.0 if dkv else 6.0) * B * H * D * allowed_pairs(Sq, Sk, ncond, kv_valid)
    n_out = 2 * Sk if dkv else Sq
    nbytes = (2 * Sq + 2 * Sk + n_out) * B * H * D * elem_bytes + 2 * B * Sq * H * 4
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def bsa_pairs(idx, block_q: int, block_k: int, Sq: int, bound: int) -> int:
    """(query, key) pairs a block selection ``idx`` [BH, nQb, k] lets
    through: for each (b*h, q-block), its rows times the keys of its
    selected blocks below the bound."""
    import torch

    nQb = idx.shape[1]
    rows = torch.tensor([min(Sq, (i + 1) * block_q) - i * block_q for i in range(nQb)],
                        device=idx.device, dtype=torch.float64)
    start = idx.long() * block_k
    keys = (torch.clamp(torch.minimum(start + block_k, torch.full_like(start, bound))
                        - start, min=0)).double().sum(-1)
    return int(float((keys * rows[None]).sum()))


def bsa_bound_s(B, H, Sq, Sk, D, pairs, elem_bytes, qk_int8, peaks) -> float:
    if qk_int8:  # int8 QK^T at the int8 rate, PV at the 16-bit rate
        t_ops = 2.0 * D * pairs / peaks["int8_ops"] + 2.0 * D * pairs / peaks["bf16_flops"]
        nbytes = (B * Sq * H * (D + 4) + B * Sk * H * (D + 4)
                  + (B * Sk + B * Sq) * H * D * elem_bytes)
    else:
        t_ops = 4.0 * D * pairs / peaks["bf16_flops"]
        nbytes = (2 * B * Sq + 2 * B * Sk) * H * D * elem_bytes
    return max(t_ops, nbytes / peaks["hbm_bytes_per_s"])


def least_s(l: Launch, peaks) -> float:
    """The least time of one launch at the card's peaks."""
    if l.kernel == "flash_fwd":
        return bound_s(l.B, l.H, l.Sq, l.Sk, l.D, l.ncond, l.kv_valid, l.elem_bytes, peaks)
    if l.kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        return bwd_bound_s(l.B, l.H, l.Sq, l.Sk, l.D, l.ncond, l.kv_valid, l.elem_bytes,
                           l.kernel == "flash_bwd_dkv", peaks)
    if l.kernel == "bsa_fwd":
        return bsa_bound_s(l.B, l.H, l.Sq, l.Sk, l.D, launch_pairs(l), l.elem_bytes, False,
                           peaks)
    raise ValueError(f"unknown kernel {l.kernel!r}")


def attn(B, H, Sq, Sk, D, ncond=0, kv_valid=None, backward: Optional[str] = None) -> Work:
    """One attention: its forward launch, and with ``backward`` "dq" or
    "dqkv" the backward launches the gradient needs; FLOPs included."""
    w = Work(launches=[Launch("flash_fwd", B, H, Sq, Sk, D, ncond, kv_valid)])
    if backward:
        w.launches.append(Launch("flash_bwd_dq", B, H, Sq, Sk, D, ncond, kv_valid))
        if backward == "dqkv":
            w.launches.append(Launch("flash_bwd_dkv", B, H, Sq, Sk, D, ncond, kv_valid))
    w.flops = w.attention_flops()
    return w


def matmul(rows: int, k: int, n: int, backward: bool = False) -> Work:
    """A linear of ``rows`` x ``k`` by ``k`` x ``n``; with ``backward`` also
    the gradient of its input (the weights are frozen: no weight gradient)."""
    return Work(flops=2.0 * rows * k * n * (2 if backward else 1))
