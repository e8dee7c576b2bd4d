"""The TTA sweep as one client drives it: video after video, each with a
fresh adapter (``tta/adapters.py::build_scheme``), a fresh AdamW state,
the anchored early stopper set up on it (its step-0 anchor), then chunks
of ``check_every`` optimizer steps through ``tta/engine.py::train_chunk``,
each followed by the stopper's anchor check, as ``runners/run_tta.py``'s
``_adapt`` runs them. The stopper's checks run; its stop decision is not
acted on, so every seed does the same work.

Each video's latents, text embedding and per-step (sigma, noise) are
drawn from ``--seed`` and the video's index on the device; the VAE and
the text encoders are outside the window. Set-up builds the training step
(model, scheme, optimizer, stopper), sets up video 0 and drives its first
``check.steps`` optimizer steps through ``train_chunk`` (one step, then
the rest): they warm up every shape and give the readings the check holds
against the plain reference. The window then carries on with the same
objects from video 0's next step, and ends at the first chunk boundary
past ``--seconds``.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict

import torch

from ..draws import generator, normal

NOT_FINITE = 1e308  # a compared number that came out NaN or infinite (JSON has no inf)


class Driver:
    def __init__(self, cell, model, seed: int, device):
        self.cell, self.m, self.seed, self.device = cell, model, seed, torch.device(device)
        t = cell.traffic
        self.t = t
        f = t["vae_spatial_factor"]
        self.lat_h, self.lat_w = t["height"] // f, t["width"] // f
        self.units: Dict[str, int] = {"train_step": 0, "anchor": 0}
        self.attempted = self.failed = 0
        self.readings: Dict = {}
        self.want = None      # the reference's numbers, once computed
        self.numbers: Dict[str, float] = {}

    def geometry(self) -> Dict:
        t, p = self.t, self.cell.config["patch_size"]
        ph, pw = (p[1], p[2]) if isinstance(p, list) else (p, p)
        return dict(nhw=(self.lat_h // ph) * (self.lat_w // pw), cond_latents=t["cond_latents"],
                    train_latents=t["train_latents"], val_latents=t["val_latents"],
                    anchor_rows=len(t["anchor_sigmas"]) * t["noise_draws"])

    # -- inputs --------------------------------------------------------------
    def video(self, v: int) -> Dict:
        """Video ``v``'s inputs, all on the device: latents, text, the
        stopper's fixed noises and every step's (sigma, noise)."""
        t, m, dev = self.t, self.m, self.device
        g = generator(dev, self.seed, "video", v)
        shape = lambda n: (1, m.latent_channels, n, self.lat_h, self.lat_w)
        cond = normal(shape(t["cond_latents"]), g, dev)
        train = normal(shape(t["train_latents"]), g, dev)
        val = normal(shape(t["val_latents"]), g, dev)
        L, dim = m.text_shape
        text = normal((1, L, dim), g, dev, m.dtype)
        lo, hi = t["text_valid_tokens"]
        n_valid = int(torch.randint(lo, hi + 1, (1,), generator=g, device=dev).item())
        mask = (torch.arange(L, device=dev) < n_valid).to(torch.int32)[None]
        fixed = normal((t["noise_draws"],) + shape(t["val_latents"]), g, dev)
        noised = t["train_latents"] + (t["cond_latents"] if m.noise_covers_cond else 0)
        draws = []
        for _ in range(t["steps_per_video"]):
            sigma = torch.rand((1,), generator=g, device=dev) * (1.0 - 0.001) + 0.001
            draws.append((sigma, normal(shape(noised), g, dev)))
        return dict(index=v, cond=cond, train=train, val=val, text=text, mask=mask,
                    fixed=fixed, draws=draws, pos=0)

    # -- the training step ---------------------------------------------------
    def setup(self) -> None:
        from longcat_video_tta_tpu_torch.config import (
            AdapterConfig, EarlyStoppingConfig, OptimConfig)
        from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
        from longcat_video_tta_tpu_torch.tta.early_stopping import build_early_stopper
        from longcat_video_tta_tpu_torch.tta.engine import build_optimizer

        t, m = self.t, self.m
        self.scheme = build_scheme(m.dit_cfg, AdapterConfig(method=t["method"]))
        self.opt = build_optimizer(OptimConfig(lr=t["lr"], steps=t["steps_per_video"]))
        self.escfg = EarlyStoppingConfig(check_every=t["check_every"],
                                         anchor_sigmas=tuple(t["anchor_sigmas"]),
                                         noise_draws=t["noise_draws"])
        self.stopper = build_early_stopper(self.escfg, self.scheme, m.dit_cfg,
                                           anchor_fn=m.arch.anchor)
        self.cur = self.start_video(0, None)
        n = self.cell.limits["check"]["steps"]
        c = self.cur
        tp0 = c["tp"]
        losses = self.chunk(c, 1, anchor=False)
        mu = {k: v.clone() for k, v in c["state"]["mu"].items()}
        losses += self.chunk(c, n - 1, anchor=False)
        self.readings = dict(video=c, tp0=tp0, mu1=mu, losses=losses, anchor0=c["anchor0"],
                             tpn={k: v.clone() for k, v in c["tp"].items()}, steps=n)

    def start_video(self, v: int, spans) -> Dict:
        if spans is not None:
            spans.mark("video")
        c = self.video(v)
        c["tp"] = self.scheme.init(self.device, dit=self.m.dit)
        c["state"] = self.opt.init(c["tp"])
        if spans is not None:
            spans.mark("setup_anchor")
        self.stopper.setup(self.m.dit, c["cond"], c["val"], c["text"], c["mask"],
                           f"video{v}", c["tp"], fixed_noises=c["fixed"])
        c["anchor0"] = self.stopper.best_loss
        return c

    def chunk(self, c: Dict, k: int, anchor: bool, spans=None):
        """``k`` steps of video ``c`` through ``train_chunk`` (with the
        anchor after them when ``anchor``), then the host's read of the
        losses and the anchor, as the runner reads them."""
        from longcat_video_tta_tpu_torch.tta.engine import train_chunk

        pos = c["pos"]
        mark = spans.mark if spans is not None else None
        c["tp"], c["state"], loss, a = train_chunk(
            self.scheme, self.m.dit, self.opt, c["tp"], c["state"], c["cond"], c["train"],
            c["text"], c["mask"], steps=k, draws=c["draws"][pos:pos + k],
            val_latents=c["val"] if anchor else None,
            fixed_noises=c["fixed"] if anchor else None,
            anchor_sigmas=self.escfg.anchor_sigmas, on_phase=mark,
            loss_fn=self.m.arch.loss, anchor_fn=self.m.arch.anchor)
        if spans is not None:
            spans.mark("host")
        losses = loss.tolist()
        c["pos"] = pos + k
        if anchor:
            self.stopper.step_with_loss(c["pos"], c["tp"], float(a))
        return losses

    def window(self, deadline: float, spans) -> None:
        t = self.t
        every, steps = t["check_every"], t["steps_per_video"]
        c = self.cur
        while True:
            if c["pos"] >= steps:
                c = self.start_video(c["index"] + 1, spans)
                self.units["anchor"] += 1
            k = min(every - c["pos"] % every, steps - c["pos"])
            anchor = (c["pos"] + k) % every == 0
            losses = self.chunk(c, k, anchor, spans)
            self.units["train_step"] += k
            self.units["anchor"] += int(anchor)
            self.attempted += k
            self.failed += sum(not math.isfinite(x) for x in losses)
            if time.perf_counter() >= deadline:
                break
        self.cur = None

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"tta_step_s": window_s / max(1, self.units["train_step"])}

    # -- the check -------------------------------------------------------------
    def check(self, lowp: bool = False, fault: str = "",
              every: bool = False) -> Dict[str, Dict[str, float]]:
        """The readings of set-up against the plain reference's: each
        step's loss, the first gradient (norm and direction, from AdamW's
        first moment after step 1), the change of the adapter after the
        steps, and the step-0 anchor (only where the cell compares it, or
        with ``every``). With ``lowp`` the reference in float8 stands in
        for the program (the control); with ``fault`` "half" the reference
        whose loss leaves out half of the target's elements."""
        from ..core import module_for

        r = self.readings
        limits = self.cell.limits["limits"]
        anchor = every or "anchor_gap" in limits
        ref_mod = module_for("reference", self.cell.backbone)
        if self.want is None:
            self.want = self.reference_numbers(ref_mod, False, with_anchor=anchor)
        want = self.want
        if lowp or fault:
            got = self.reference_numbers(ref_mod, lowp, fault, with_anchor=anchor)
        else:
            (delta0,), (mu1,), (deltan,) = (list(r[k].values()) for k in ("tp0", "mu1", "tpn"))
            got = dict(losses=r["losses"], grad=mu1.float() / (1 - self.opt.cfg.betas[0]),
                       change=(deltan - delta0).float(), anchor=r["anchor0"] if anchor else None)
        self.numbers = compare(got, want)
        return {k: {"value": v, "limit": limits[k]} for k, v in self.numbers.items()
                if k in limits}

    def reference_numbers(self, ref_mod, lowp: bool, fault: str = "",
                          with_anchor: bool = True) -> Dict:
        """The reference's run of the same steps: AdamW as optax runs it
        (global-norm clip, bias-corrected moments, eps outside the root,
        decoupled decay), from the same initial delta, on the same
        draws; and the step-0 anchor when ``with_anchor``."""
        from ..reference.common import fp32_matmuls

        r, c = self.readings, self.readings["video"]
        ocfg = self.opt.cfg
        b1, b2 = ocfg.betas
        ref = ref_mod.MODEL(self.cell.config, self.m.weights, lowp=lowp)
        delta = next(iter(r["tp0"].values())).float().clone()
        mu, nu = torch.zeros_like(delta), torch.zeros_like(delta)
        losses, grad = [], None
        t0 = time.perf_counter()
        anchor = None
        with fp32_matmuls():
            if with_anchor:
                anchor = ref_mod.anchor_loss(ref, c["cond"], c["val"], c["text"], c["mask"],
                                             c["fixed"], self.escfg.anchor_sigmas, delta)
            t_anchor = time.perf_counter() - t0
            for i in range(r["steps"]):
                d = delta.clone().requires_grad_(True)
                sigma, noise = c["draws"][i]
                with torch.enable_grad():
                    loss = ref_mod.tta_loss(ref, c["cond"], c["train"], c["text"], c["mask"],
                                            sigma, noise, d, half=fault == "half")
                    (g,) = torch.autograd.grad(loss, [d])
                losses.append(float(loss.detach()))
                norm = g.norm()
                if i == 0:
                    raw = norm
                if norm >= ocfg.grad_clip_norm:
                    g = g / norm * ocfg.grad_clip_norm
                if grad is None:
                    grad = g.clone()
                mu = (1 - b1) * g + b1 * mu
                nu = (1 - b2) * g * g + b2 * nu
                u = (mu / (1 - b1 ** (i + 1))) / (torch.sqrt(nu / (1 - b2 ** (i + 1))) + ocfg.eps)
                delta = delta - ocfg.lr * (u + ocfg.weight_decay * delta)
        print(f"[reference] lowp={lowp} fault={fault or '-'}: anchor {t_anchor:.1f} s, "
              f"{r['steps']} steps {time.perf_counter() - t0 - t_anchor:.1f} s, first gradient's "
              f"norm before the clip {float(raw):.6g}", file=sys.stderr, flush=True)
        return dict(losses=losses, grad=grad, change=delta - next(iter(r["tp0"].values())).float(),
                    anchor=anchor)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a check compares. A norm's gap is the gap
    between the two norms over the reference's norm (the adapter is one
    leaf); the direction's gap is 1 - cos."""
    g_p, g_r = prog["grad"].flatten().double(), ref["grad"].flatten().double()
    c_p, c_r = prog["change"].flatten().double(), ref["change"].flatten().double()
    numbers = {
        "loss_gap": max(_rel(a, b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": _rel(float(g_p.norm()), float(g_r.norm())),
        "grad_dir_gap": float(1 - torch.dot(g_p, g_r)
                              / (g_p.norm() * g_r.norm()).clamp_min(1e-300)),
        "change_gap": _rel(float(c_p.norm()), float(c_r.norm())),
    }
    if prog["anchor"] is not None and ref["anchor"] is not None:
        numbers["anchor_gap"] = _rel(float(prog["anchor"]), float(ref["anchor"]))
    return {k: (v if math.isfinite(v) else NOT_FINITE) for k, v in numbers.items()}
