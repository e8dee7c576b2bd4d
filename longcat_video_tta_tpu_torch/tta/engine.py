"""TTA optimization engine (counterpart of
``longcat_video_tta_tpu/tta/engine.py``): the optimizer, one train step,
and the k-step chunk with the folded anchor evaluation.

The optimizer reproduces optax's arithmetic, not torch's helpers:
``clip_by_global_norm`` scales by max_norm / norm only when norm >=
max_norm (torch's ``clip_grad_norm_`` divides by norm + 1e-6); the
warmup is ``optax.linear_schedule(0, lr, warmup)``, so the first step
runs at lr 0; AdamW adds eps outside the square root (no eps_root) and
decays weights after the Adam scaling, before the learning rate. With
eps 1e-15 the first Adam step is lr * sign(g) in every coordinate.

Updates are functional: a step returns new tensors and never writes into
the old ones, so the early stopper keeps plain references as snapshots.
For the adapter methods the trainable state is a few small tensors. For
``full`` it is every DiT weight: the first state shares the base model's
storage, and from the first step on the current weights, the best
snapshot (when it is not the current or the base state), the gradients
and AdamW's mu and nu (in the parameters' dtype, as optax keeps them)
each take one more model's worth of memory, and during an update the new
weights and moments exist beside the old ones.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import OptimConfig
from ..models.dit import LongCatDiT
from .adapters import AdapterScheme, TrainParams
from .losses import (
    flow_matching_loss_conditioned,
    flow_matching_loss_conditioned_fixed,
)


def global_norm(tree: TrainParams) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tree.values()))


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip_norm), adamw | sgd)``
    as ``build_optimizer`` configures it. State is a dict of tensors plus
    the step count; nothing here syncs with the host."""

    def __init__(self, ocfg: OptimConfig):
        if ocfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {ocfg.optimizer}")
        self.cfg = ocfg

    def init(self, params: TrainParams) -> Dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        if self.cfg.optimizer == "adamw":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        return {"count": 0, "trace": zeros() if self.cfg.momentum else None}

    def learning_rate(self, count: int) -> float:
        """optax.linear_schedule(0, lr, warmup_steps) at ``count`` (the
        count before this step), or the constant lr."""
        c = self.cfg
        if c.warmup_steps <= 0:
            return c.lr
        frac = 1.0 - min(max(count, 0), c.warmup_steps) / c.warmup_steps
        return (0.0 - c.lr) * frac + c.lr

    def update(self, grads: TrainParams, state: Dict,
               params: TrainParams) -> Tuple[TrainParams, Dict]:
        """One step -> (new params, new state). Tensor by tensor: clip by
        the global norm (optax.clip_by_global_norm: t / norm * max_norm
        when norm >= max_norm, t otherwise), then the AdamW or SGD update;
        no clipped copy of all the gradients is made at once."""
        c = self.cfg
        max_norm = c.grad_clip_norm
        norm = global_norm(grads)
        keep = norm < max_norm
        lr = self.learning_rate(state["count"])
        count = state["count"] + 1
        b1, b2 = c.betas
        new, mu, nu, trace = {}, {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            g = torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            if c.optimizer == "adamw":
                mu[k] = (1 - b1) * g + b1 * state["mu"][k]
                nu[k] = (1 - b2) * g * g + b2 * state["nu"][k]
                u = (mu[k] / (1 - b1 ** count)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** count)) + c.eps)
                g = u + c.weight_decay * p
            elif c.momentum:
                g = trace[k] = g + c.momentum * state["trace"][k]
            new[k] = p + (-lr) * g
        if c.optimizer == "adamw":
            return new, {"count": count, "mu": mu, "nu": nu}
        return new, {"count": count, "trace": trace if c.momentum else None}


def build_optimizer(ocfg: OptimConfig) -> Optimizer:
    """AdamW (betas, eps 1e-15, decoupled weight decay) or SGD (momentum
    optional), after a global-norm clip, with optional linear warmup."""
    return Optimizer(ocfg)


def train_step(scheme: AdapterScheme, dit: LongCatDiT, opt: Optimizer,
               train_params: TrainParams, opt_state: Dict, cond_latents,
               target_latents, text_emb, text_mask, *,
               sigma: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               num_valid_target: Optional[int] = None,
               loss_fn: Callable = flow_matching_loss_conditioned):
    """One conditioned-loss step -> (train_params, opt_state, loss as a
    0-d tensor on the device). ``num_valid_target``: the target's valid
    latent frames when it is padded to a bucket. ``loss_fn``: the
    backbone's conditioned loss (``archs.get_arch(arch).loss``; the MMDiT's
    takes (txt, y_vec) in the (text_emb, text_mask) slots, CogVideoX's
    leaves text_mask unread)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in train_params.items()}
    with torch.enable_grad():
        fwd_dit, adapters = scheme.to_forward(leaves, dit)
        loss = loss_fn(
            fwd_dit, cond_latents, target_latents, text_emb, text_mask,
            adapters=adapters, sigma=sigma, noise=noise, generator=generator,
            num_valid_target=num_valid_target)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    # a tensor the loss does not reach gets a zero gradient, as in the reference
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    del leaves
    train_params, opt_state = opt.update(grads, opt_state, train_params)
    return train_params, opt_state, loss.detach()


def anchor_loss(scheme: AdapterScheme, dit: LongCatDiT, train_params: TrainParams,
                cond_latents, val_latents, text_emb, text_mask, fixed_noises,
                anchor_sigmas: Sequence[float],
                anchor_fn: Callable = flow_matching_loss_conditioned_fixed
                ) -> torch.Tensor:
    """The early stopper's fixed-sigma anchor loss on the adapted model
    (a 0-d tensor on the device; no gradient is recorded)."""
    with torch.no_grad():
        fwd_dit, adapters = scheme.to_forward(train_params, dit)
        return anchor_fn(
            fwd_dit, cond_latents, val_latents, text_emb, text_mask, fixed_noises,
            fixed_sigmas=tuple(anchor_sigmas), adapters=adapters)


def train_chunk(scheme: AdapterScheme, dit: LongCatDiT, opt: Optimizer,
                train_params: TrainParams, opt_state: Dict, cond_latents,
                target_latents, text_emb, text_mask, *, steps: int,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
                val_latents=None, fixed_noises=None,
                anchor_sigmas: Sequence[float] = (),
                on_phase: Optional[Callable[[str], None]] = None,
                variants: Optional[Sequence[Dict]] = None,
                select: Optional[Sequence[int]] = None,
                loss_fn: Callable = flow_matching_loss_conditioned,
                anchor_fn: Callable = flow_matching_loss_conditioned_fixed):
    """``steps`` optimizer steps, then (when ``val_latents`` is given) the
    anchor eval on the final params: the reference's ``make_train_chunk``
    as a plain loop. Nothing syncs with the host; the caller fetches
    (losses, anchor) once per chunk.

    Step i trains on ``variants[select[i]]`` when ``variants`` is given
    (dicts with "cond", "train", "emb", "mask" and optionally "valid":
    augmentation variants, or the batch-TTA round robin over a video and
    its neighbours), else on the positional latents; the anchor always runs on the positional
    ``cond_latents``, ``text_emb`` and ``text_mask`` (the reference's
    stack entry 0). Per step, (sigma, noise) come from ``draws`` when
    given (tests inject the reference's draws), else the loss draws them
    from ``generator`` at the shape it noises (the step's padded target;
    CogVideoX's whole window).
    ``on_phase(name)`` is called as "train_chunk" and "anchor_check"
    begin. ``loss_fn`` / ``anchor_fn``: the backbone's losses
    (``archs.py``). Returns (train_params, opt_state, losses [steps] on the
    device, anchor 0-d tensor or None)."""
    mark = on_phase or (lambda name: None)
    mark("train_chunk")
    losses: List[torch.Tensor] = []
    for i in range(steps):
        if variants is not None:
            v = variants[select[i]]
            batch = (v["cond"], v["train"], v["emb"], v["mask"], v.get("valid"))
        else:
            batch = (cond_latents, target_latents, text_emb, text_mask, None)
        sigma, noise = draws[i] if draws is not None else (None, None)
        train_params, opt_state, loss = train_step(
            scheme, dit, opt, train_params, opt_state, *batch[:4], sigma=sigma,
            noise=noise, generator=generator, num_valid_target=batch[4],
            loss_fn=loss_fn)
        losses.append(loss)
    anchor = None
    if val_latents is not None:
        mark("anchor_check")
        anchor = anchor_loss(scheme, dit, train_params, cond_latents, val_latents,
                             text_emb, text_mask, fixed_noises, anchor_sigmas,
                             anchor_fn=anchor_fn)
    return train_params, opt_state, torch.stack(losses), anchor


def adapter_norm(train_params: TrainParams) -> float:
    """delta_norm-style diagnostic: the global norm of the trainable
    tensors."""
    return float(global_norm(train_params))
