"""TTA optimization engine (counterpart of
``longcat_video_tta_tpu/tta/engine.py``): the optimizer, one train step,
the k-step chunk with the folded anchor evaluation, and its
video-parallel form (``train_chunk_batched``: V videos' adapters trained
as one batch, the reference's ``make_batched_train_chunk``).

The optimizer reproduces optax's arithmetic, not torch's helpers:
``clip_by_global_norm`` scales by max_norm / norm only when norm >=
max_norm (torch's ``clip_grad_norm_`` divides by norm + 1e-6); the
warmup is ``optax.linear_schedule(0, lr, warmup)``, so the first step
runs at lr 0; AdamW adds eps outside the square root (no eps_root) and
decays weights after the Adam scaling, before the learning rate. With
eps 1e-15 the first Adam step is lr * sign(g) in every coordinate.

Under a mesh (the DiT's ``mesh``, ``parallel/``) every rank draws the
whole sigma and noise from the same generator and the DiT gathers its
output, so every rank computes the same loss. A trainable tensor then
holds only its rank's share of the gradient (from its tokens under the
context axis, its batch rows under the data axis): ``train_step`` sums
the gradients over the context group (averages them over the data
group) before the update. Tensor-parallel linears return whole
gradients through Megatron's f (``ops/layers.py``); a sharded tensor's
gradient is its shard's. The clip norm is global: a sharded tensor
counts once per shard, a replicated one once. The losses and the anchor
that leave a chunk are rank 0's, so every rank's early stopper decides
alike.

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
from ..parallel.collectives import all_reduce, all_reduce_grads, broadcast
from ..utils.spans import span
from .adapters import AdapterScheme, TrainParams
from .losses import (
    flow_matching_loss_conditioned,
    flow_matching_loss_conditioned_fixed,
    fold_lanes,
)


def global_norm(tree: TrainParams, sharded=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm).
    ``sharded``: (tensor group, names) of tensors that hold a
    tensor-parallel slice: their squares are summed over the group, the
    rest counted once."""
    if sharded is None or sharded[0] is None:
        return torch.sqrt(sum((x.float() ** 2).sum() for x in tree.values()))
    group, names = sharded
    sq = lambda keys: sum(((tree[k].float() ** 2).sum() for k in keys),
                          torch.zeros((), device=next(iter(tree.values())).device))
    local = sq([k for k in tree if k in names])
    return torch.sqrt(sq([k for k in tree if k not in names]) + all_reduce(local, group))


def mesh_of(dit):
    """The DiT's mesh when it splits the tokens or the linears, else None
    (a data-only mesh splits lanes, which train on their own)."""
    mesh = getattr(dit, "mesh", None)
    if mesh is None or mesh.size("context") * mesh.size("tensor") == 1:
        return None
    return mesh


def sharded_leaves(dit, tree: TrainParams):
    """(tensor group, names of ``tree``'s tensor-parallel slices) for the
    global clip norm, or None."""
    mesh = getattr(dit, "mesh", None)
    if mesh is None or mesh.size("tensor") == 1:
        return None
    from ..parallel.sharding import sharded_names

    names = sharded_names(dit)
    return mesh.group("tensor"), {k for k in tree if k in names}


def agree(x: torch.Tensor, dit) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of the DiT's mesh (losses and anchors
    the early stopper reads), ``x`` without one."""
    if mesh_of(dit) is None:
        return x
    import torch.distributed as dist

    return broadcast(x, dist.group.WORLD)


def lane_norms(tree: TrainParams) -> torch.Tensor:
    """[V]: each lane's global norm, over every tensor's non-lane axes
    (optax.global_norm of each video's tree under the reference's vmap)."""
    return torch.sqrt(sum((x.float() ** 2).flatten(1).sum(1) for x in tree.values()))


def lane_slice(tree: TrainParams, v: int) -> TrainParams:
    """Lane ``v`` of a lane-stacked tree (views)."""
    return {k: x[v] for k, x in tree.items()}


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

    def update(self, grads: TrainParams, state: Dict, params: TrainParams,
               lanes: bool = False, sharded=None) -> Tuple[TrainParams, Dict]:
        """One step -> (new params, new state). Tensor by tensor: clip by
        the global norm (optax.clip_by_global_norm: t / norm * max_norm
        when norm >= max_norm, t otherwise), then the AdamW or SGD update;
        no clipped copy of all the gradients is made at once. With
        ``lanes`` every tensor has a leading lane axis and each lane is
        clipped by its own norm; AdamW and SGD are elementwise, so the rest
        is per lane as it stands, and the lanes share the step count (they
        always step together). ``sharded``: the tensor-parallel slices
        among the tensors (``sharded_leaves``), for the global norm."""
        with span("tta.optimizer"):
            c = self.cfg
            max_norm = c.grad_clip_norm
            norm = lane_norms(grads) if lanes else global_norm(grads, sharded)
            keep = norm < max_norm
            lr = self.learning_rate(state["count"])
            count = state["count"] + 1
            b1, b2 = c.betas
            new, mu, nu, trace = {}, {}, {}, {}
            for k, p in params.items():
                g = grads[k]
                if lanes:  # [V] -> [V, 1, ...]
                    shape = (-1,) + (1,) * (g.ndim - 1)
                    g = torch.where(keep.reshape(shape), g,
                                    g / norm.reshape(shape).to(g.dtype) * max_norm)
                else:
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


def _grads(loss: torch.Tensor, leaves) -> Tuple:
    """``autograd.grad`` of ``loss`` w.r.t. ``leaves`` (None for a leaf
    the loss does not reach). Under anomaly detection (the runner's
    --debug-nans) a backward function that returns NaN raises
    FloatingPointError, as the reference's jax_debug_nans does."""
    try:
        with span("tta.backward"):
            return torch.autograd.grad(loss, list(leaves), allow_unused=True)
    except RuntimeError as e:
        if torch.is_anomaly_enabled() and "nan" in str(e):
            raise FloatingPointError(str(e)) from e
        raise


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
    with span("tta.step"):
        leaves = {k: v.detach().requires_grad_(True) for k, v in train_params.items()}
        with torch.enable_grad():
            with span("tta.forward"):
                fwd_dit, adapters = scheme.to_forward(leaves, dit)
                loss = loss_fn(
                    fwd_dit, cond_latents, target_latents, text_emb, text_mask,
                    adapters=adapters, sigma=sigma, noise=noise, generator=generator,
                    num_valid_target=num_valid_target)
            grads = _grads(loss, leaves.values())
        # a tensor the loss does not reach gets a zero gradient, as in the reference
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        del leaves
        mesh = getattr(dit, "mesh", None)
        loss = loss.detach()
        if mesh is not None:
            # each rank's share of a replicated tensor's gradient: its tokens
            # (context), its batch rows (data: the loss is a mean over rows)
            grads = all_reduce_grads(grads, mesh.group("context"))
            grads = all_reduce_grads(grads, mesh.group("data"), mean=True)
            if mesh.group("data") is not None:
                loss = all_reduce(loss, mesh.group("data")) / mesh.size("data")
        train_params, opt_state = opt.update(grads, opt_state, train_params,
                                             sharded=sharded_leaves(dit, train_params))
    return train_params, opt_state, loss


def anchor_loss(scheme: AdapterScheme, dit: LongCatDiT, train_params: TrainParams,
                cond_latents, val_latents, text_emb, text_mask, fixed_noises,
                anchor_sigmas: Sequence[float],
                anchor_fn: Callable = flow_matching_loss_conditioned_fixed
                ) -> torch.Tensor:
    """The early stopper's fixed-sigma anchor loss on the adapted model
    (a 0-d tensor on the device; no gradient is recorded)."""
    with torch.no_grad(), span("tta.anchor"):
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
        anchor = agree(anchor_loss(scheme, dit, train_params, cond_latents, val_latents,
                                   text_emb, text_mask, fixed_noises, anchor_sigmas,
                                   anchor_fn=anchor_fn), dit)
    return train_params, opt_state, agree(torch.stack(losses), dit), anchor


def train_chunk_batched(scheme: AdapterScheme, dit: LongCatDiT, opt: Optimizer,
                        train_params: TrainParams, opt_state: Dict, cond, train,
                        emb, mask, *, steps: int,
                        generators: Optional[Sequence[torch.Generator]] = None,
                        draws: Optional[Sequence[Sequence[Tuple]]] = None,
                        val_latents=None, fixed_noises=None,
                        anchor_sigmas: Sequence[float] = (),
                        on_phase: Optional[Callable[[str], None]] = None,
                        loss_fn: Callable = flow_matching_loss_conditioned,
                        anchor_fn: Callable = flow_matching_loss_conditioned_fixed):
    """``steps`` optimizer steps of V videos at once, then (when
    ``val_latents`` is given) each one's anchor: the reference's
    ``make_batched_train_chunk`` (its vmap over videos) with the videos
    folded into the batch axis, so each step is one forward and one
    backward over V rows and every kernel launch carries all of them.

    ``train_params`` and ``opt_state``'s moments carry a leading lane axis
    V (stacked per-video inits); the DiT is one shared copy. ``cond``,
    ``train``, ``emb``, ``mask`` (or None), ``val_latents`` are stacked
    [V, b, ...], ``fixed_noises`` [V, n_draws, b, ...]. Each lane keeps its
    own clip norm and AdamW state, its loss is its own mean (the folded
    loss sums the lanes' means), and its (sigma, noise) come from
    ``generators[v]`` in the order its own ``train_chunk`` would draw
    them, or from ``draws[i][v]`` (tests inject the reference's). Returns
    (train_params, opt_state, losses [V, steps] on the device, anchors
    [V] or None)."""
    mark = on_phase or (lambda name: None)
    V = len(cond)
    if draws is None and (generators is None or len(generators) != V):
        raise ValueError("train_chunk_batched draws from one generator per lane")
    fold = lambda x: None if x is None else fold_lanes(list(x))
    cond_f, train_f, emb_f, mask_f = (fold(x) for x in (cond, train, emb, mask))
    mark("train_chunk")
    losses: List[torch.Tensor] = []
    for i in range(steps):
        sigma = noise = None
        if draws is not None:
            sigma = fold_lanes([d[0] for d in draws[i]])
            noise = fold_lanes([d[1] for d in draws[i]])
        with span("tta.step"):
            leaves = {k: v.detach().requires_grad_(True) for k, v in train_params.items()}
            with torch.enable_grad():
                with span("tta.forward"):
                    fwd_dit, adapters = scheme.to_forward(leaves, dit)
                    loss = loss_fn(fwd_dit, cond_f, train_f, emb_f, mask_f,
                                   adapters=adapters, sigma=sigma, noise=noise,
                                   generator=None if generators is None else list(generators),
                                   lanes=V)
                grads = _grads(loss.sum(), leaves.values())
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
            del leaves
            train_params, opt_state = opt.update(grads, opt_state, train_params, lanes=True)
        losses.append(loss.detach())
    anchors = None
    if val_latents is not None:
        mark("anchor_check")
        noises = torch.stack([fold_lanes(list(fixed_noises[:, d]))
                              for d in range(fixed_noises.shape[1])])
        with torch.no_grad(), span("tta.anchor"):
            fwd_dit, adapters = scheme.to_forward(train_params, dit)
            anchors = anchor_fn(fwd_dit, cond_f, fold(val_latents), emb_f, mask_f, noises,
                                fixed_sigmas=tuple(anchor_sigmas), adapters=adapters,
                                lanes=V)
    return train_params, opt_state, torch.stack(losses, dim=1), anchors


def adapter_norm(train_params: TrainParams) -> float:
    """delta_norm-style diagnostic: the global norm of the trainable
    tensors."""
    return float(global_norm(train_params))
