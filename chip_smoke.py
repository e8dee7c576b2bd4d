#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases (each one fails the run when it fails):
  1. build: compile csrc/flash_fwd.cu and csrc/flash_bwd.cu with nvcc
     (sm_90a, one nvcc per source, started together) into
     longcat_video_tta_tpu_torch/csrc/build/ and print the build times and
     ptxas resource lines;
  2. kernel check: the flash-attention kernel against its plain PyTorch
     version (``attention_reference``) in bf16 at the main path's shapes
     (decode self-attention, cross-attention, the no-cache prefix-masked
     self-attention), the decode self-attention of the runner's default
     geometry, plus small ragged / fp16 / head_dim 32 and 64 cases,
     with the error against a stated tolerance; times of the kernel, the
     plain version and torch's scaled_dot_product_attention (yardstick
     only; the port never calls it) beside the least time the card could
     take (the bound);
  3. backward kernel check: the dQ and dK/dV kernels against
     ``attention_backward_reference`` on the card at the training shapes
     (the delta_a train step's self-attention, 10 920 tokens with a
     6240-token prefix, and its cross-attention dQ against 512 text
     tokens) plus small ragged / fp16 / no-visible-key cases, with the
     per-output gates below; times of each kernel, the plain version and
     torch's scaled_dot_product_attention backward (yardstick only)
     beside each kernel's bound;
  4. small-input agreement: ``generate_vc`` on the card against the same
     weights and noise on the CPU (plain path), and one delta_a train
     step's loss and delta gradient on the card against the CPU, same
     weights and injected sigma and noise, longcat_demo widths;
  5. main path, serving: the port's runner (``--method none``) answers 2
     requests at LongCat-13.6B width (DiT 4096 / 32x128 heads / ffn 11008
     / 48 blocks, UMT5-XXL, WAN VAE base 96; bf16, random weights drawn
     on the card from a seed) at 480x832 with 5 conditioning frames, 8
     generated frames, 4 denoising steps and guidance 4.0. The forward
     kernel's launch count over this run must equal the number of
     attention calls on the path, and PSNR/SSIM must be finite;
  6. main path, TTA: the runner's ``--method delta_a`` on 2 videos at the
     same widths and depth: a 29-frame TTA window (4 cond, 3 train, 1 val
     latents: one 10 920-token train sequence), 6 AdamW steps with the
     anchor check every 3, then generation as in 5 with the trained
     delta. Each kernel's launch count must equal the count the code
     implies (``tta_launches``); losses, the anchor history and
     PSNR/SSIM must be finite and the adapter must have moved.

The counts of every kernel are set to 0 just before each main path and
read just after; a kernel's ``launches`` in the kernels line is its sum
over the two main paths. The line before the last is {"kernels": [...]};
the last line is {"ok": true, "device": {...}}. Without a CUDA GPU the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, ".chip_smoke")

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
# Gates on o, set by the reference's own scale (|o| shrinks as the
# softmax spreads over more keys). A sound kernel's o differs from the
# reference's by the two roundings to the 16-bit output (at most one ulp
# of each element) plus P rounded at another running max (far less):
#   max|o - o_ref|   <= 2 eps * max|o_ref|   (2 to 4 ulp of the largest |o|)
#   ||o - o_ref||_2  <=   eps * ||o_ref||_2  (a spread error, such as a
#                                             dropped or rounded PV term)
# with eps the dtype's machine epsilon (bf16 2^-7, fp16 2^-10).
O_EPS = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
LSE_TOL = 1e-3  # fp32 log-sum-exp: summation order only
# Backward gates, per output d of (dq, dk, dv), against the plain version
# on the same o, lse and do: the two roundings of the 16-bit output, plus
# P and dS rounded to 16 bits at fp32 values that differ in the last bits
# (summation order of S and dP), each a flip of at most one ulp on a few
# elements of a long sum:
#   max|d - d_ref|   <= 4 eps * max|d_ref|
#   ||d - d_ref||_2  <= 2 eps * ||d_ref||_2
GRAD_MAX_EPS, GRAD_L2_EPS = 4.0, 2.0
GRAD_NAMES = {"flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv")}
E2E_PSNR_MIN = 30.0  # card vs CPU generate_vc on the same weights and noise
# card vs CPU delta_a train step (bf16 model, the CPU runs the plain path)
STEP_LOSS_RTOL, STEP_GRAD_COS_MIN, STEP_GRAD_REL_L2 = 1e-2, 0.99, 5e-2

# main-path geometry (LongCat-13.6B widths, full 480x832 frames)
MAIN = dict(height=480, width=832, cond_frames=5, gen_frames=8, steps=4,
            guidance=4.0, requests=2)
# delta_a main path: the demo campaign's 29-frame TTA window
# (campaign/demo/_delta_a.yaml) at full width and depth. Cut: 13
# conditioning frames, 8 generated frames, 6 TTA steps with the anchor
# check every 3, 4 denoising steps, 2 videos.
TTA = dict(height=480, width=832, cond_frames=13, tta_total_frames=29,
           gen_frames=8, tta_steps=6, check_every=3, patience=3,
           inference_steps=4, guidance=4.0, videos=2)


def _events_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _allowed_pairs(Sq: int, Sk: int, ncond: int, kv_valid=None) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    kv = Sk if kv_valid is None else min(Sk, kv_valid)
    pairs = Sq * kv
    if ncond > 0 and Sq == Sk:
        cond_rows = min(ncond, Sq)
        noise_keys = max(0, kv - ncond)
        pairs -= cond_rows * noise_keys
    return pairs


def _bound_ms(B, H, Sq, Sk, D, ncond, kv_valid, elem_bytes):
    flops = 4.0 * B * H * D * _allowed_pairs(Sq, Sk, ncond, kv_valid)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem_bytes + B * Sq * H * 4
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bwd_bound_ms(B, H, Sq, Sk, D, ncond, kv_valid, elem_bytes, dkv: bool):
    """Least time of one backward kernel: 8*D FLOP per allowed pair for
    dK/dV (S, dP, dV, dK), 6*D for dQ (S, dP, dQ); bytes: q, k, v, dO and
    the fp32 lse and delta read once, dq (or dk and dv) written once."""
    flops = (8.0 if dkv else 6.0) * B * H * D * _allowed_pairs(Sq, Sk, ncond, kv_valid)
    n_out = 2 * Sk if dkv else Sq
    nbytes = ((2 * Sq + 2 * Sk + n_out) * B * H * D * elem_bytes + 2 * B * Sq * H * 4)
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _reference_chunked(fa, q, k, v, ncond, kv_valid, heads_per_chunk):
    """attention_reference over head chunks (the S x S fp32 matrix of all
    heads at once does not fit beside the inputs)."""
    import torch

    outs, lses = [], []
    for h0 in range(0, q.shape[2], heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        o, lse = fa.attention_reference(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                        num_cond_tokens=ncond,
                                        kv_valid_len=kv_valid)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def case_inputs(B, H, Sq, Sk, D, *, dtype_name="bfloat16", fused_kv=False, seed=0):
    """Seeded q, k, v on the card; with ``fused_kv`` k and v are strided
    views of one [B, Sk, 2, H, D] tensor (the cross-attention layout)."""
    import torch

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    if fused_kv:  # k, v as strided views of a fused [B, Sk, 2, H, D] output
        kv = torch.randn((B, Sk, 2, H, D), generator=g, device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        k = torch.randn((B, Sk, H, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, Sk, H, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def reference(fa, q, k, v, ncond, kv_valid):
    """The plain version, chunked over heads to fit beside the inputs."""
    B, Sq, H, _ = q.shape
    chunk = max(1, min(H, int(2e9 // (4 * B * Sq * k.shape[1] * 4)) or 1))
    return _reference_chunked(fa, q, k, v, ncond, kv_valid, chunk)


def kernel_errors(o, lse, o_ref, lse_ref, dtype_name):
    """The kernel's errors against the plain version, each gate's limit,
    and whether every gate holds."""
    d = o.float() - o_ref.float()
    eps = O_EPS[dtype_name]
    e = {"max_abs_err": float(d.abs().max()),
         "o_tol": 2 * eps * float(o_ref.float().abs().max()),
         "l2_err": float(d.norm()),
         "l2_tol": eps * float(o_ref.float().norm()),
         "max_abs_err_lse": float((lse - lse_ref).abs().max())}
    e["ok"] = (math.isfinite(e["max_abs_err"]) and e["max_abs_err"] <= e["o_tol"]
               and e["l2_err"] <= e["l2_tol"] and e["max_abs_err_lse"] <= LSE_TOL)
    return e


def check_kernel_case(fa, name, B, H, Sq, Sk, D, *, ncond=0, kv_valid=None,
                      dtype_name="bfloat16", fused_kv=False, timed=False, seed=0):
    """Kernel vs plain version on one shape; returns a result dict."""
    import torch
    import torch.nn.functional as F

    q, k, v = case_inputs(B, H, Sq, Sk, D, dtype_name=dtype_name, fused_kv=fused_kv,
                          seed=seed)
    o, lse = fa.flash_attention(q, k, v, num_cond_tokens=ncond, kv_valid_len=kv_valid)
    torch.cuda.synchronize()
    o_ref, lse_ref = reference(fa, q, k, v, ncond, kv_valid)
    torch.cuda.synchronize()
    err = kernel_errors(o, lse, o_ref, lse_ref, dtype_name)
    ok = err.pop("ok")
    res = {"case": name, "B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D, "ncond": ncond,
           "kv_valid": kv_valid, "dtype": dtype_name, **err}
    if not ok:
        raise AssertionError(f"kernel case {name}: {json.dumps(res)} "
                             f"(lse tol {LSE_TOL})")
    del o_ref, lse_ref
    if timed:
        res["ms"] = _events_ms(lambda: fa.flash_attention(
            q, k, v, num_cond_tokens=ncond, kv_valid_len=kv_valid), iters=10)
        res["plain_ms"] = _events_ms(lambda: reference(fa, q, k, v, ncond, kv_valid),
                                     iters=1, warmup=0)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if ncond > 0 and Sq == Sk:
            idx = torch.arange(Sq, device="cuda")
            mask = (idx[:, None] >= ncond) | (idx[None, :] < ncond)
        res["library_ms"] = _events_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=10)
        res["bound_ms"], res["bound_by"] = _bound_ms(
            B, H, Sq, Sk, D, ncond, kv_valid, q.element_size())
    return res


def main_path_cases(dit_cfg, tokens_per_frame):
    """(name, shape args, options) of the attention calls the main path
    makes, plus the decode self-attention of the runner's default
    geometry (14 cond frames -> 4 latents, 28 -> 29 generated frames ->
    8 latents)."""
    B, H, D = 2, dit_cfg.num_heads, dit_cfg.head_dim  # CFG batch
    n_cond_lat = 1 + (MAIN["cond_frames"] - 1) // 4
    n_gen_frames = ((MAIN["gen_frames"] - 1 + 3) // 4) * 4 + 1
    n_gen_lat = (n_gen_frames - 1) // 4 + 1
    s_cond, s_gen = n_cond_lat * tokens_per_frame, n_gen_lat * tokens_per_frame
    return [
        ("decode_self", (B, H, s_gen, s_cond + s_gen, D), {}),
        ("cross", (B, H, s_gen, dit_cfg.text_len, D), dict(fused_kv=True, seed=1)),
        ("nocache_prefix", (B, H, s_cond + s_gen, s_cond + s_gen, D),
         dict(ncond=s_cond, seed=2)),
        ("decode_self_default_geometry",
         (B, H, 8 * tokens_per_frame, 12 * tokens_per_frame, D), dict(seed=7)),
    ]


def phase_kernel_checks(fa, dit_cfg, tokens_per_frame):
    cases = [check_kernel_case(fa, name, *shape, timed=True, **opts)
             for name, shape, opts in main_path_cases(dit_cfg, tokens_per_frame)]
    cases += [
        check_kernel_case(fa, "ragged_kv_valid", 1, 3, 200, 333, 64,
                          kv_valid=250, seed=3),
        check_kernel_case(fa, "ragged_prefix_d32", 2, 2, 150, 150, 32, ncond=37,
                          seed=4),
        check_kernel_case(fa, "fp16_d128", 1, 2, 96, 130, 128,
                          dtype_name="float16", seed=5),
        check_kernel_case(fa, "no_visible_key", 1, 2, 64, 64, 64, kv_valid=0, seed=6),
    ]
    for c in cases:
        print("[kernel] " + json.dumps(c))
    return cases


def backward_reference(fa, q, k, v, o, lse, do, ncond, kv_valid):
    """The plain backward, chunked over heads: its fp32 S, P, dP and dS of
    32 heads at 10 920^2 would not fit beside the inputs."""
    import torch

    B, Sq, H, _ = q.shape
    chunk = max(1, min(H, int(6e9 // (8 * B * Sq * k.shape[1] * 4))))
    outs = []
    for h0 in range(0, H, chunk):
        sl = slice(h0, h0 + chunk)
        outs.append(fa.attention_backward_reference(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], o[:, :, sl], lse[:, :, sl],
            do[:, :, sl], num_cond_tokens=ncond, kv_valid_len=kv_valid))
    return tuple(torch.cat(parts, dim=2) for parts in zip(*outs))


def grad_errors(d, d_ref, dtype_name):
    eps = O_EPS[dtype_name]
    diff, ref = d.float() - d_ref.float(), d_ref.float()
    e = {"max_abs_err": float(diff.abs().max()),
         "max_tol": GRAD_MAX_EPS * eps * float(ref.abs().max()),
         "l2_err": float(diff.norm()),
         "l2_tol": GRAD_L2_EPS * eps * float(ref.norm())}
    e["ok"] = (bool(d.isfinite().all()) and e["max_abs_err"] <= e["max_tol"]
               and e["l2_err"] <= e["l2_tol"])
    return e


def check_bwd_case(fa, name, B, H, Sq, Sk, D, *, ncond=0, kv_valid=None,
                   dtype_name="bfloat16", fused_kv=False, timed=False, seed=0,
                   dkv=True, all_zero=False):
    """The dQ (and, with ``dkv``, dK/dV) kernel against the plain backward
    on one shape, from the forward kernel's o and lse; returns a result
    dict per kernel."""
    import torch
    import torch.nn.functional as F

    q, k, v = case_inputs(B, H, Sq, Sk, D, dtype_name=dtype_name, fused_kv=fused_kv,
                          seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid)
    o, lse = fa.flash_attention(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    got = {"flash_bwd_dq": (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),)}
    if dkv:
        got["flash_bwd_dkv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    ref_dq, ref_dk, ref_dv = backward_reference(fa, q, k, v, o, lse, do, ncond, kv_valid)
    refs = {"flash_bwd_dq": (ref_dq,), "flash_bwd_dkv": (ref_dk, ref_dv)}
    del ref_dq, ref_dk, ref_dv
    results = []
    for kname, outs in got.items():
        res = {"kernel": kname, "case": name, "B": B, "H": H, "Sq": Sq, "Sk": Sk,
               "D": D, "ncond": ncond, "kv_valid": kv_valid, "dtype": dtype_name}
        for oname, d, d_ref in zip(GRAD_NAMES[kname], outs, refs[kname]):
            e = grad_errors(d, d_ref, dtype_name)
            ok = e.pop("ok")
            if all_zero:
                ok = ok and float(d.abs().max()) == 0.0
            res.update({f"{oname}_{key}": val for key, val in e.items()})
            if not ok:
                raise AssertionError(f"backward case {name} {oname}: {json.dumps(res)}")
        res["max_abs_err"] = max(v_ for key, v_ in res.items()
                                 if key.endswith("_max_abs_err"))
        results.append(res)
    del refs, got
    if timed:
        plain_ms = _events_ms(lambda: backward_reference(fa, q, k, v, o, lse, do,
                                                         ncond, kv_valid),
                              iters=1, warmup=0)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        mask = None
        if ncond > 0 and Sq == Sk:
            idx = torch.arange(Sq, device="cuda")
            mask = (idx[:, None] >= ncond) | (idx[None, :] < ncond)
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2).contiguous()
        library_ms = _events_ms(lambda: ot.backward(dot, retain_graph=True), iters=5)
        del qt, kt, vt, ot, dot
        for res in results:
            is_dkv = res["kernel"] == "flash_bwd_dkv"
            fn = fa.flash_attention_bwd_dkv if is_dkv else fa.flash_attention_bwd_dq
            res["ms"] = _events_ms(lambda: fn(q, k, v, do, lse, delta, **kw), iters=10)
            # the plain version and SDPA compute dq, dk and dv in one call
            res["plain_ms"] = plain_ms
            res["library_ms"] = library_ms
            res["bound_ms"], res["bound_by"] = _bwd_bound_ms(
                B, H, Sq, Sk, D, ncond, kv_valid, q.element_size(), is_dkv)
    return results


def phase_bwd_kernel_checks(fa, dit_cfg, tokens_per_frame):
    """The backward kernels at the delta_a train step's shapes, then small
    ragged cases."""
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    n_cond_lat, n_train_lat = tta_split()[:2]
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    ncond = n_cond_lat * tokens_per_frame
    cases = check_bwd_case(fa, "train_self", 1, H, s_train, s_train, D, ncond=ncond,
                           timed=True, seed=21)
    cases += check_bwd_case(fa, "train_cross_dq", 1, H, s_train, dit_cfg.text_len, D,
                            fused_kv=True, timed=True, seed=22, dkv=False)
    cases += check_bwd_case(fa, "ragged_prefix_d32", 2, 2, 150, 150, 32, ncond=37,
                            seed=23)
    cases += check_bwd_case(fa, "ragged_kv_valid_d64", 1, 3, 200, 333, 64,
                            kv_valid=250, seed=24)
    cases += check_bwd_case(fa, "fp16_d128", 1, 2, 96, 130, 128,
                            dtype_name="float16", seed=25)
    cases += check_bwd_case(fa, "no_visible_key", 1, 2, 64, 64, 64, kv_valid=0,
                            seed=26, all_zero=True)
    for c in cases:
        print("[bwd-kernel] " + json.dumps(c))
    return cases


def phase_small_agreement():
    """generate_vc on the card vs the CPU plain path, same weights and
    noise (longcat_demo widths at a small frame size)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import longcat_demo
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc

    cpu = ModelBundle.init_random(longcat_demo(), seed=3, device="cpu")
    gpu = dataclasses.replace(
        cpu, dit=copy.deepcopy(cpu.dit).cuda(), vae=copy.deepcopy(cpu.vae).cuda(),
        text=copy.deepcopy(cpu.text).cuda(), device=torch.device("cuda"))
    rng = np.random.default_rng(0)
    cond = rng.uniform(-1, 1, (1, 3, 5, 64, 128)).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 2, 8, 16)).astype(np.float32))
    kw = dict(num_frames=5, num_inference_steps=2, init_noise=noise)
    a = generate_vc(cpu, cond, "a ball moving across the scene", **kw)
    b = generate_vc(gpu, cond, "a ball moving across the scene", **kw)
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    psnr = float("inf") if mse == 0 else -10 * math.log10(mse)
    print(f"[agree] longcat_demo generate_vc card vs cpu: shape {b.shape}, "
          f"max|diff| {float(np.abs(a - b).max()):.4g}, psnr {psnr:.2f} dB "
          f"(min {E2E_PSNR_MIN})")
    if not (np.isfinite(b).all() and psnr >= E2E_PSNR_MIN):
        raise AssertionError("card and CPU generate_vc disagree")


def delta_step(dit, delta, cond, target, emb, mask, sigma, noise):
    """Loss and d(loss)/d(delta) of one delta_a train step."""
    import torch

    from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

    delta = delta.detach().clone().requires_grad_(True)
    loss = flow_matching_loss_conditioned(dit, cond, target, emb, mask,
                                          adapters={"delta_t": delta},
                                          sigma=sigma, noise=noise)
    (grad,) = torch.autograd.grad(loss, [delta])
    return float(loss.detach()), grad.double().cpu()


def phase_step_agreement():
    """One delta_a train step (loss and delta gradient) on the card vs the
    CPU plain path: longcat_demo widths (bf16), same weights, same injected
    sigma and noise; 2 cond + 1 target latents of 8 x 16."""
    import copy

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import longcat_demo
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle

    cfg = longcat_demo()
    cpu_dit = ModelBundle.init_random(cfg, seed=4, device="cpu").dit
    gpu_dit = copy.deepcopy(cpu_dit).cuda()
    rng = np.random.default_rng(1)
    arrays = dict(
        cond=rng.standard_normal((1, 16, 2, 8, 16)),
        target=rng.standard_normal((1, 16, 1, 8, 16)),
        emb=rng.standard_normal((1, cfg.dit.text_len, cfg.dit.text_dim)),
        sigma=np.array([0.6]),
        noise=rng.standard_normal((1, 16, 1, 8, 16)),
        delta=0.1 * rng.standard_normal((cfg.dit.adaln_tembed_dim,)))
    mask = np.ones((1, cfg.dit.text_len), np.int64)
    mask[:, 20:] = 0
    on = lambda dev: dict(
        {k: torch.from_numpy(a.astype(np.float32)).to(dev) for k, a in arrays.items()},
        mask=torch.from_numpy(mask).to(dev))
    a, b = on("cpu"), on("cuda")
    args = ("delta", "cond", "target", "emb", "mask", "sigma", "noise")
    loss_c, grad_c = delta_step(cpu_dit, *(a[k] for k in args))
    loss_g, grad_g = delta_step(gpu_dit, *(b[k] for k in args))
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    cos = float((grad_g @ grad_c) / (grad_g.norm() * grad_c.norm()))
    rel_l2 = float((grad_g - grad_c).norm() / grad_c.norm())
    print(f"[agree] longcat_demo delta_a step card vs cpu: loss {loss_g:.6g} vs "
          f"{loss_c:.6g} (rel {rel_loss:.3g}, max {STEP_LOSS_RTOL}); grad cosine "
          f"{cos:.6f} (min {STEP_GRAD_COS_MIN}), rel L2 {rel_l2:.3g} "
          f"(max {STEP_GRAD_REL_L2}), |grad| {float(grad_c.norm()):.4g}")
    if not (rel_loss <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS_MIN
            and rel_l2 <= STEP_GRAD_REL_L2):
        raise AssertionError("card and CPU delta_a train steps disagree")


def phase_main_path(fa, depth):
    import numpy as np

    from longcat_video_tta_tpu_torch.runners import run_tta

    out_dir = os.path.join(RUN_DIR, "run")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--method", "none", "--preset", "longcat_13b",
            "--synthetic", str(MAIN["requests"]), "--output-dir", out_dir,
            "--device", "cuda", "--height", str(MAIN["height"]),
            "--width", str(MAIN["width"]),
            "--num-cond-frames", str(MAIN["cond_frames"]),
            "--num-frames", str(MAIN["gen_frames"]),
            "--num-inference-steps", str(MAIN["steps"]),
            "--guidance-scale", str(MAIN["guidance"]), "--no-save-videos"]
    print("[main] run_tta " + " ".join(argv))
    print(f"[main] geometry: {MAIN}; cuts: none (full depth {depth}, full widths)")
    fa.reset_launches()
    t0 = time.time()
    summary = run_tta.main(argv)
    wall = time.time() - t0
    launches = fa.launches
    shutil.rmtree(os.path.join(out_dir, "synthetic_data"), ignore_errors=True)

    per_request = [(r.get("gen_time"), r.get("total_time")) for r in summary["results"]]
    for i, r in enumerate(summary["results"]):
        print(f"[main] request {i}: success={r['success']} gen_time={r.get('gen_time')} s "
              f"total_time={r.get('total_time')} s psnr={r.get('psnr')} ssim={r.get('ssim')}"
              + (f" error={r['error']}" if "error" in r else ""))
    # attention calls per request: (cond-cache precompute + one decode
    # per step) x depth x (self + cross)
    expected = MAIN["requests"] * depth * 2 * (1 + MAIN["steps"])
    print(f"[main] wall {wall:.1f} s; flash_fwd launches {launches} (expected {expected})")
    if summary["num_success"] != MAIN["requests"]:
        raise AssertionError(f"{summary['num_success']}/{MAIN['requests']} requests succeeded")
    for r in summary["results"]:
        if not (np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])):
            raise AssertionError(f"non-finite metrics: {r}")
    if launches <= 0 or launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times on the main path, "
                             f"expected {expected}")
    return launches, per_request


def tta_split():
    """(cond, train, val) latents of the TTA window, as the runner splits
    it (tta/split.py)."""
    from longcat_video_tta_tpu_torch.tta.split import estimate_tta_split_budget

    s = estimate_tta_split_budget(TTA["tta_total_frames"],
                                  min(TTA["cond_frames"], TTA["tta_total_frames"]))
    return s["cond_latents"], s["train_latents"], s["val_latents"]


def tta_launches(depth: int):
    """Launches per kernel that the delta_a path implies for one video,
    with 2 attention calls (self + cross) per block:
      - a train step runs the forward once, then the full-remat backward
        recomputes every block (forward kernel again) and runs dQ for
        both attentions and dK/dV for self-attention only (cross-
        attention's k, v come from the frozen text path): forward
        2 x 2 x depth, dQ 2 x depth, dK/dV depth;
      - an anchor eval is one batched forward: 2 x depth; there is one at
        setup and one per check (steps // check_every, no early stop
        since patience exceeds the number of checks);
      - generation: the cond-cache precompute plus one decode per step,
        each 2 x depth, as in the serving path."""
    steps, checks = TTA["tta_steps"], TTA["tta_steps"] // TTA["check_every"]
    assert checks < TTA["patience"]
    per_attn = 2 * depth
    return {
        "flash_fwd": steps * 2 * per_attn + (1 + checks) * per_attn
        + per_attn * (1 + TTA["inference_steps"]),
        "flash_bwd_dq": steps * per_attn,
        "flash_bwd_dkv": steps * depth,
    }


def phase_tta_path(fa, depth):
    import numpy as np

    from longcat_video_tta_tpu_torch.runners import run_tta

    out_dir = os.path.join(RUN_DIR, "tta")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--method", "delta_a", "--preset", "longcat_13b",
            "--synthetic", str(TTA["videos"]), "--output-dir", out_dir,
            "--device", "cuda", "--height", str(TTA["height"]),
            "--width", str(TTA["width"]),
            "--num-cond-frames", str(TTA["cond_frames"]),
            "--tta-total-frames", str(TTA["tta_total_frames"]),
            "--num-frames", str(TTA["gen_frames"]),
            "--steps", str(TTA["tta_steps"]),
            "--es-check-every", str(TTA["check_every"]),
            "--es-patience", str(TTA["patience"]),
            "--num-inference-steps", str(TTA["inference_steps"]),
            "--guidance-scale", str(TTA["guidance"]), "--no-save-videos"]
    print("[tta] run_tta " + " ".join(argv))
    print(f"[tta] geometry: {TTA}; split (cond, train, val) latents {tta_split()}; "
          f"cuts: frame and step counts only (full depth {depth}, full widths)")
    fa.reset_launches()
    t0 = time.time()
    summary = run_tta.main(argv)
    wall = time.time() - t0
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    shutil.rmtree(os.path.join(out_dir, "synthetic_data"), ignore_errors=True)

    for i, r in enumerate(summary["results"]):
        print(f"[tta] video {i}: success={r['success']} train_time={r.get('train_time')} s "
              f"es_check_time={r.get('es_check_time')} s gen_time={r.get('gen_time')} s "
              f"total_time={r.get('total_time')} s losses={r.get('losses')} "
              f"adapter_norm={r.get('adapter_norm')} psnr={r.get('psnr')} "
              f"ssim={r.get('ssim')} early_stopping_info={r.get('early_stopping_info')}"
              + (f" error={r['error']}" if "error" in r else ""))
    expected = {k: TTA["videos"] * n for k, n in tta_launches(depth).items()}
    print(f"[tta] wall {wall:.1f} s; launches {got} (expected {expected})")
    if summary["num_success"] != TTA["videos"]:
        raise AssertionError(f"{summary['num_success']}/{TTA['videos']} videos succeeded")
    for r in summary["results"]:
        history = [loss for _, loss in r["early_stopping_info"]["loss_history"]]
        finite = np.isfinite(r["losses"] + history + [r["psnr"], r["ssim"]]).all()
        if not (finite and len(r["losses"]) == TTA["tta_steps"] and r["adapter_norm"] > 0):
            raise AssertionError(f"delta_a video result out of bounds: {r}")
    if got != expected or min(got.values()) <= 0:
        raise AssertionError(f"kernel launches on the delta_a path {got}, expected {expected}")
    return got


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from longcat_video_tta_tpu_torch.config import longcat_13b
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    # stated precision: fp32 matmuls and convolutions in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    for path, log, seconds in fa.build_libraries():
        print(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"[build] {line.split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")

    cfg = longcat_13b()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tokens_per_frame = (MAIN["height"] // sf) * (MAIN["width"] // sf)
    cases = phase_kernel_checks(fa, cfg.dit, tokens_per_frame)
    torch.cuda.empty_cache()
    bwd_cases = phase_bwd_kernel_checks(fa, cfg.dit, tokens_per_frame)
    torch.cuda.empty_cache()
    phase_small_agreement()
    phase_step_agreement()
    torch.cuda.empty_cache()
    serving_launches, _ = phase_main_path(fa, cfg.dit.depth)
    torch.cuda.empty_cache()
    tta = phase_tta_path(fa, cfg.dit.depth)

    def entry(name, source, replaces, launches, all_cases):
        timed = next(c for c in all_cases if "ms" in c)
        return {"name": name, "route": "cuda",
                "source": f"longcat_video_tta_tpu_torch/csrc/{source}",
                "replaces": f"longcat_video_tta_tpu/ops/flash_attention.py:{replaces}",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in all_cases),
                **{key: timed[key] for key in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}}

    by_kernel = lambda name: [c for c in bwd_cases if c["kernel"] == name]
    kernels = [
        entry("flash_fwd", "flash_fwd.cu", 133,
              serving_launches + tta["flash_fwd"], cases),
        entry("flash_bwd_dq", "flash_bwd.cu", 327, tta["flash_bwd_dq"],
              by_kernel("flash_bwd_dq")),
        entry("flash_bwd_dkv", "flash_bwd.cu", 261, tta["flash_bwd_dkv"],
              by_kernel("flash_bwd_dkv")),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
