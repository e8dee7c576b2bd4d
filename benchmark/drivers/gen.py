"""Video continuation as one client drives it: continuation after
continuation through ``pipeline/sampler.py::sample_latents`` (the
runner's ``generate_vc`` minus the VAE and the text encoder): each builds
its own conditioning KV cache, then runs the traffic's CFG Euler steps on
the [negative; positive] pair, dense (no decode lever).

Each continuation's conditioning latents, prompt and negative-prompt
embeddings and initial noise are drawn from ``--seed`` and its index on
the device. Set-up warms up the cell's shapes with a two-step
continuation (the cache and the CFG step at the timed sizes). The window
ends at the first denoising step that begins past ``--seconds``, found
by the sampler's ``on_phase("step")`` mark: the continuation in flight is
stopped there (from the hook), after the steps it has enqueued finish,
and its completed steps count.

For the check, the benchmark keeps the program's latents before and
after a few steps of the first continuation (a wrapper around the
scheduler's Euler step reads them); the plain reference recomputes those
steps from the same state with its own conditioning cache.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from ..draws import generator, normal
from .tta import NOT_FINITE


class _WindowEnd(Exception):
    pass


class Driver:
    def __init__(self, cell, model, seed: int, device):
        self.cell, self.m, self.seed, self.device = cell, model, seed, torch.device(device)
        t = cell.traffic
        self.t = t
        f = t["vae_spatial_factor"]
        self.lat_h, self.lat_w = t["height"] // f, t["width"] // f
        self.units: Dict[str, int] = {"cond_cache": 0, "denoise_step": 0}
        self.attempted = self.failed = 0
        self.first = None
        self.saved: Dict[int, tuple] = {}
        self.want = None  # the reference's steps, once computed
        self.numbers: Dict[str, float] = {}

    def geometry(self) -> Dict:
        t, p = self.t, self.cell.config["patch_size"]
        ph, pw = (p[1], p[2]) if isinstance(p, list) else (p, p)
        return dict(nhw=(self.lat_h // ph) * (self.lat_w // pw), cond_latents=t["cond_latents"],
                    gen_latents=t["gen_latents"])

    def request(self, c) -> Dict:
        t, m, dev = self.t, self.m, self.device
        g = generator(dev, self.seed, "continuation", c)
        shape = lambda n: (1, m.latent_channels, n, self.lat_h, self.lat_w)
        L, dim = m.text_shape
        lo, hi = t["text_valid_tokens"]
        out = dict(index=c, cond=normal(shape(t["cond_latents"]), g, dev))
        for side in ("text", "neg"):
            out[side] = normal((1, L, dim), g, dev, m.dtype)
            n = int(torch.randint(lo, hi + 1, (1,), generator=g, device=dev).item())
            out[side + "_mask"] = (torch.arange(L, device=dev) < n).to(torch.int32)[None]
        out["noise"] = normal(shape(t["gen_latents"]), g, dev)
        return out

    def sample(self, r: Dict, steps: int, on_phase=None):
        from longcat_video_tta_tpu_torch.pipeline.sampler import sample_latents

        t = self.t
        with torch.no_grad():
            return sample_latents(
                self.m.dit, self.m.scheduler, r["text"], r["text_mask"], r["neg"],
                r["neg_mask"], t["guidance"], num_gen_latents=t["gen_latents"],
                num_steps=steps, lat_h=self.lat_h, lat_w=self.lat_w, cond_latents=r["cond"],
                use_kv_cache=True, init_noise=r["noise"], on_phase=on_phase)

    def setup(self) -> None:
        bool(torch.isfinite(self.sample(self.request("warmup"), 2)).all())
        steps = self.t["steps"]
        g = generator("cpu", self.seed, "check steps")
        others = torch.randperm(steps - 1, generator=g)[: self.cell.limits["check"]["steps"] - 1]
        self.check_steps = sorted({0} | {int(i) + 1 for i in others})

    def window(self, deadline: float, spans) -> None:
        from longcat_video_tta_tpu_torch.models import scheduler

        steps = self.t["steps"]
        euler = scheduler.euler_step
        state = {"c": 0, "i": -1}

        def keep(x, v, sigma, sigma_next):
            out = euler(x, v, sigma, sigma_next)
            if state["c"] == 0 and state["i"] in self.check_steps:
                self.saved[state["i"]] = (x.clone(), out.clone())
            return out

        def hook(name: str) -> None:
            spans.mark(name)
            if name != "step":
                return
            state["i"] += 1
            if state["i"] == 0:
                self.units["cond_cache"] += 1
            elif time.perf_counter() >= deadline:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                raise _WindowEnd

        scheduler.euler_step = keep
        try:
            while True:
                state["i"] = -1
                spans.mark("request")
                r = self.request(state["c"])
                try:
                    x = self.sample(r, steps, hook)
                except _WindowEnd:
                    self.units["denoise_step"] += state["i"]
                    self.attempted += state["i"]
                    break
                spans.mark("host")
                self.units["denoise_step"] += steps
                self.attempted += steps
                if not bool(torch.isfinite(x).all()):
                    self.failed += steps
                if state["c"] == 0:
                    self.first = r
                state["c"] += 1
                if time.perf_counter() >= deadline:
                    break
        finally:
            scheduler.euler_step = euler
        if self.first is None:  # the first continuation was cut: check its finished steps
            self.first = r
            self.check_steps = [i for i in self.check_steps if i in self.saved]

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"denoise_step_s": window_s / max(1, self.units["denoise_step"])}

    def check(self, lowp: bool = False) -> Dict[str, Dict[str, float]]:
        """Each kept step of the first continuation against the plain
        reference's step from the same latents, with the reference's own
        conditioning cache and schedule: the gap of the steps' updates,
        ||dx - dx_ref|| / ||dx_ref||, the worst of the kept steps. With
        ``lowp`` the reference in float8 stands in for the program (the
        control)."""
        from ..core import module_for
        from ..reference.common import fp32_matmuls

        ref_mod = module_for("reference", self.cell.backbone)
        r, t = self.first, self.t
        cfg = self.cell.config
        text2 = torch.cat([r["neg"], r["text"]], 0)
        mask2 = torch.cat([r["neg_mask"], r["text_mask"]], 0)
        sig = ref_mod.sigmas(t["steps"], cfg["scheduler_shift"], device=self.device)

        def steps(lowp: bool) -> Dict[int, torch.Tensor]:
            ref = ref_mod.MODEL(cfg, self.m.weights, lowp=lowp)
            with fp32_matmuls(), torch.no_grad():
                cache = ref.cond_cache(torch.cat([r["cond"], r["cond"]], 0), text2, mask2)
                return {i: ref_mod.denoise_step(ref, self.saved[i][0], sig[i], sig[i + 1], text2,
                                                mask2, cache, t["cond_latents"], t["guidance"])
                        for i in self.check_steps}

        if self.want is None:
            self.want = steps(False)
        got = steps(True) if lowp else {i: self.saved[i][1] for i in self.check_steps}
        gap = 0.0
        for i in self.check_steps:
            x = self.saved[i][0]
            want = self.want[i] - x
            g = float((got[i].float() - x - want).norm() / want.norm().clamp_min(1e-30))
            gap = max(gap, g if math.isfinite(g) else NOT_FINITE)
        self.numbers = {"step_gap": gap}
        return {"step_gap": {"value": gap, "limit": self.cell.limits["limits"]["step_gap"]}}
