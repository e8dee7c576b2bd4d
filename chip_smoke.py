#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases (each one fails the run when it fails):
  1. build: compile csrc/flash_fwd.cu, csrc/flash_bwd.cu and csrc/bsa.cu with nvcc
     (sm_90a, one nvcc per source, started together) into
     longcat_video_tta_tpu_torch/csrc/build/ and print the build times and
     ptxas resource lines;
  2. kernel check: the flash-attention kernel against its plain PyTorch
     version (``attention_reference``) in bf16 at the main path's shapes
     (decode self-attention, cross-attention, the no-cache prefix-masked
     self-attention), the decode self-attention of the runner's default
     geometry, the delta_a train step's and anchor eval's self-attention,
     plus small ragged / fp16 / head_dim 32 and 64 cases,
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
  3b. BSA kernel check: the gathered-attention kernel (16-bit and
     int8-QK) against ``bsa_reference`` on the same selection at the lever
     runs' decode shapes (top_k 8 and 10 at the default geometry, 6 at the
     --fast-decode one), every block selected against the forward kernel,
     small ragged / kv_valid / fp16 / head_dim 32 and 64 / 32- and
     512-token-block cases; the block-sum kernel against
     ``block_sum_reference``; times beside the plain version, dense SDPA,
     compiled flex_attention with a BlockMask (yardsticks only) and the
     bound over the pairs the selection lets through;
  4. small-input agreement: ``generate_vc`` on the card against the same
     weights and noise on the CPU (plain path), dense and with every
     decode lever (BSA with 32-token blocks, int8qk, PAB, CFG reuse), and one delta_a train
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
     PSNR/SSIM must be finite and the adapter must have moved;
  7. main paths, decode levers: the runner at the same widths and depth,
     2 requests each of 28 generated frames, 8 denoising steps: run A
     (14 cond frames, ``--bsa-keep-ratio 0.5 --fast-decode-verify 1``)
     and run B (5 cond frames, ``--fast-decode --quantize-decode int8qk
     --gen-segment-steps 4``: W8A8, int8-QK BSA at keep 0.35, PAB, CFG
     reuse). Each kernel's launch count must equal ``lever_launches``;
     PSNR/SSIM and run A's fast-vs-dense PSNR must be finite.

The counts of every kernel are set to 0 just before each main path and
read just after; a kernel's ``launches`` in the kernels line is its sum
over the main paths. The line before the last is {"kernels": [...]};
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


def tta_kernel_cases(dit_cfg, tokens_per_frame):
    """The forward kernel at the delta_a shapes it runs most: the train
    step's self-attention (one 10 920-token sequence, 6240-token prefix;
    192 launches per step with the cross-attention and the remat
    recompute) and the anchor eval's (6 rows of 4 cond + 1 val latents,
    7800 tokens; 96 launches per eval)."""
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    n_cond_lat, n_train_lat, n_val_lat = tta_split()
    ncond = n_cond_lat * tokens_per_frame
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    s_anchor = (n_cond_lat + n_val_lat) * tokens_per_frame
    return [("train_self", (1, H, s_train, s_train, D), dict(ncond=ncond, seed=8)),
            ("anchor_self", (6, H, s_anchor, s_anchor, D), dict(ncond=ncond, seed=9))]


def phase_kernel_checks(fa, dit_cfg, tokens_per_frame):
    cases = [check_kernel_case(fa, name, *shape, timed=True, **opts)
             for name, shape, opts in (main_path_cases(dit_cfg, tokens_per_frame)
                                       + tta_kernel_cases(dit_cfg, tokens_per_frame))]
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


# BSA gates. 16-bit kernel vs its plain version: the forward kernel's
# gates (the same arithmetic over the selected keys). int8-QK kernel vs
# its plain version: p = bf16(exp(bf16(s - m))) is rounded at the
# kernel's running maximum and at the plain version's row maximum, which
# moves a p by up to |s - m| * 2^-9 (about 2% at s - m = -10, 0.6% on
# the p that matter) on top of the output roundings:
#   max|o - o_ref| <= 4 eps max|o_ref|,  ||o - o_ref||_2 <= 2 eps ||o_ref||_2,
# with eps = 2^-7 (bf16) for either output dtype, since p is bf16 in both.
# Block sums (fp32 over <= 1024 tokens, summed in another order):
#   max|s - s_ref| <= 1e-5 * max over the block of sum |x|, plus 1e-6.
BSA_INT8_MAX_EPS, BSA_INT8_L2_EPS = 4.0, 2.0
SUM_RTOL = 1e-5
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak (SXM, 700 W)


def bsa_pairs(idx, block_q: int, block_k: int, Sq: int, bound: int) -> int:
    """(query, key) pairs the selection lets through: for each (b*h,
    q-block), its rows times the keys of its selected blocks below the
    bound. The work this input needs."""
    import torch

    nQb = idx.shape[1]
    rows = torch.tensor([min(Sq, (i + 1) * block_q) - i * block_q for i in range(nQb)],
                        device=idx.device, dtype=torch.float64)
    start = idx.long() * block_k
    keys = (torch.clamp(torch.minimum(start + block_k, torch.full_like(start, bound))
                        - start, min=0)).double().sum(-1)  # [BH, nQb]
    return int(float((keys * rows[None]).sum()))


def bsa_bound_ms(B, H, Sq, Sk, D, pairs, elem_bytes, qk_int8):
    if qk_int8:  # int8 QK^T at the int8 rate, PV at the 16-bit rate
        t_ops = (2.0 * D * pairs / H100_INT8_OPS + 2.0 * D * pairs / H100_BF16_FLOPS) * 1e3
        nbytes = (B * Sq * H * (D + 4) + B * Sk * H * (D + 4)
                  + (B * Sk + B * Sq) * H * D * elem_bytes)
    else:
        t_ops = 4.0 * D * pairs / H100_BF16_FLOPS * 1e3
        nbytes = (2 * B * Sq + 2 * B * Sk) * H * D * elem_bytes
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bsa_errors(o, o_ref, dtype_name, qk_int8):
    # int8 mode rounds p to bf16 whatever the output dtype: its gates use
    # bf16's eps
    eps = O_EPS["bfloat16" if qk_int8 else dtype_name]
    mx, l2 = (BSA_INT8_MAX_EPS, BSA_INT8_L2_EPS) if qk_int8 else (2.0, 1.0)
    d, ref = o.float() - o_ref.float(), o_ref.float()
    e = {"max_abs_err": float(d.abs().max()), "o_tol": mx * eps * float(ref.abs().max()),
         "l2_err": float(d.norm()), "l2_tol": l2 * eps * float(ref.norm())}
    e["ok"] = (bool(o.isfinite().all()) and e["max_abs_err"] <= e["o_tol"]
               and e["l2_err"] <= e["l2_tol"])
    return e


def flex_block_mask(idx, B, H, Sq, Sk, block_q, block_k, bs=128):
    """torch's BlockMask for the selection ``idx``: every selected
    (q-block, k-block) pair as full 128 x 128 tiles, so the compiled
    kernel evaluates no mask inside them; ``mask_mod`` states the same
    selection for flex_attention's unfused path."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask

    nQ, nK = -(-Sq // bs), -(-Sk // bs)
    rq, rk = block_q // bs, block_k // bs
    top_k = idx.shape[2]
    qsel = idx.long().reshape(B, H, -1, top_k).repeat_interleave(rq, dim=2)[:, :, :nQ]
    kv = (qsel[..., None] * rk + torch.arange(rk, device=idx.device)).flatten(-2)
    cnt = (kv < nK).sum(-1).to(torch.int32)
    # tiles past the last key sort to the end, past each row's count
    kv = torch.where(kv < nK, kv, torch.full_like(kv, nK)).sort(-1).values
    full = torch.zeros((B, H, nQ, nK), dtype=torch.int32, device=idx.device)
    n = min(nK, kv.shape[-1])
    full[..., :n] = kv[..., :n].clamp(max=nK - 1).to(torch.int32)
    sel = torch.zeros((B * H, idx.shape[1], -(-Sk // block_k)), dtype=torch.bool,
                      device=idx.device)
    sel.scatter_(2, idx.long(), True)
    sel = sel.reshape(B, H, idx.shape[1], -1)

    def mask_mod(b, h, q_idx, kv_idx):
        return sel[b, h, q_idx // block_q, kv_idx // block_k]

    return BlockMask.from_kv_blocks(torch.zeros_like(cnt), torch.zeros_like(full), cnt,
                                    full, BLOCK_SIZE=bs, mask_mod=mask_mod,
                                    seq_lengths=(Sq, Sk))


def flex_library_ms(q, k, v, idx, block_q, block_k, o_ref):
    """Time of torch's compiled flex_attention on the selection ``idx`` (a
    yardstick the port never calls), its error against the plain
    version, or (None, reason, None)."""
    import torch

    try:
        from torch.nn.attention.flex_attention import flex_attention
        B, Sq, H, _ = q.shape
        bm = flex_block_mask(idx, B, H, Sq, k.shape[1], block_q, block_k)
        fn = torch.compile(flex_attention, dynamic=False)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        err = float((fn(qt, kt, vt, block_mask=bm).transpose(1, 2).float()
                     - o_ref.float()).abs().max())
        return _events_ms(lambda: fn(qt, kt, vt, block_mask=bm), iters=10), None, err
    except Exception as exc:  # the yardstick only: its absence fails nothing
        return None, f"{type(exc).__name__}: {str(exc)[:200]}", None


def check_bsa_case(fa, bsa, name, B, H, Sq, Sk, D, *, top_k, block_q=1024,
                   block_k=1024, ncond=0, kv_valid=None, dtype_name="bfloat16",
                   qk_int8=False, timed=False, seed=0, dense_check=False):
    """BSA kernel vs its plain version on one shape and selection."""
    import torch
    import torch.nn.functional as F

    q, k, v = case_inputs(B, H, Sq, Sk, D, dtype_name=dtype_name, seed=seed)
    idx = bsa.select_blocks(q, k, block_q=block_q, block_k=block_k, top_k=top_k,
                            num_cond_tokens=ncond, q_token_offset=Sk - Sq,
                            kv_valid=kv_valid)
    kw = dict(block_q=block_q, block_k=block_k, kv_valid=kv_valid, qk_int8=qk_int8)
    o = bsa.bsa_forward(q, k, v, idx, **kw)
    torch.cuda.synchronize()
    o_ref = bsa.bsa_reference(q, k, v, idx, **kw)
    torch.cuda.synchronize()
    e = bsa_errors(o, o_ref, dtype_name, qk_int8)
    ok = e.pop("ok")
    bound = Sk if kv_valid is None else min(Sk, kv_valid)
    res = {"kernel": "bsa_fwd_qk_int8" if qk_int8 else "bsa_fwd", "case": name,
           "B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D, "top_k": top_k,
           "block_q": block_q, "block_k": block_k, "ncond": ncond, "kv_valid": kv_valid,
           "dtype": dtype_name, **e}
    if qk_int8:  # fidelity of int8qk: against the 16-bit plain version
        o16 = bsa.bsa_reference(q, k, v, idx, block_q=block_q, block_k=block_k,
                                kv_valid=kv_valid)
        d = (o.float() - o16.float())
        res["vs_16bit_rel_l2"] = float(d.norm() / o16.float().norm())
        res["vs_16bit_max_abs"] = float(d.abs().max())
        del o16
    if dense_check:  # every block selected: the B1 kernel's output
        o_fa, _ = fa.flash_attention(q, k, v, kv_valid_len=kv_valid)
        fe = kernel_errors(o, torch.zeros(1), o_fa, torch.zeros(1), dtype_name)
        res["vs_flash_fwd_max_abs_err"] = fe["max_abs_err"]
        ok = ok and fe["ok"]
    if not ok:
        raise AssertionError(f"bsa case {name}: {json.dumps(res)}")
    if timed:
        res["ms"] = _events_ms(lambda: bsa.bsa_forward(q, k, v, idx, **kw), iters=10)
        res["plain_ms"] = _events_ms(lambda: bsa.bsa_reference(q, k, v, idx, **kw),
                                     iters=1, warmup=0)
        res["pairs"] = bsa_pairs(idx, block_q, block_k, Sq, bound)
        res["bound_ms"], res["bound_by"] = bsa_bound_ms(
            B, H, Sq, Sk, D, res["pairs"], q.element_size(), qk_int8)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        res["sdpa_dense_ms"] = _events_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=5)
        del qt, kt, vt
        if qk_int8:
            res["library_ms"], res["library_note"] = None, "no library int8-QK attention"
        elif kv_valid is None:
            t0 = time.time()
            res["library_ms"], res["library_note"], res["library_max_abs_err"] = \
                flex_library_ms(q, k, v, idx, block_q, block_k, o_ref)
            res["library_wall_s"] = time.time() - t0  # compile included
    return res


def check_block_sum_case(bsa, name, B, S, H, D, bs, *, dtype_name="bfloat16",
                         timed=False, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, H, D), generator=g, device="cuda").to(getattr(torch, dtype_name))
    s = bsa._block_sum(x, bs)
    ref = bsa.block_sum_reference(x, bs)
    scale = bsa.block_sum_reference(x.abs(), bs)
    err = float((s - ref).abs().max())
    tol_ok = bool(((s - ref).abs() <= SUM_RTOL * scale + 1e-6).all())
    res = {"kernel": "bsa_block_sum", "case": name, "B": B, "S": S, "H": H, "D": D,
           "bs": bs, "dtype": dtype_name, "max_abs_err": err,
           "max_rel_to_abs_sum": float(((s - ref).abs() / (scale + 1e-30)).max())}
    if not (tol_ok and bool(s.isfinite().all())):
        raise AssertionError(f"block-sum case {name}: {json.dumps(res)}")
    if timed:
        nb = -(-S // bs)
        res["ms"] = _events_ms(lambda: bsa._block_sum(x, bs), iters=20)
        res["plain_ms"] = _events_ms(lambda: bsa.block_sum_reference(x, bs), iters=3)
        xp = torch.cat([x, x.new_zeros((B, nb * bs - S, H, D))], 1) if nb * bs > S else x
        res["library_ms"] = _events_ms(
            lambda: xp.view(B, nb, bs, H, D).sum(2, dtype=torch.float32), iters=20)
        nbytes = B * S * H * D * x.element_size() + B * nb * H * D * 4
        res["bound_ms"], res["bound_by"] = nbytes / H100_BYTES_PER_S * 1e3, "bytes"
    return res


def bsa_geometries(tokens_per_frame):
    """(Sq, Sk) of the decode self-attention: the runner's default request
    (14 cond frames -> 4 latents, 28 generated frames -> 8 latents) and
    the --fast-decode run (5 cond frames -> 2 latents)."""
    s_gen = 8 * tokens_per_frame
    return {"default": (s_gen, 12 * tokens_per_frame, 4 * tokens_per_frame),
            "fast_decode": (s_gen, 10 * tokens_per_frame, 2 * tokens_per_frame)}


def phase_bsa_kernel_checks(fa, bsa, dit_cfg, tokens_per_frame):
    """Kernels 4 and 5 against their plain versions on the same selection,
    at the lever runs' decode shapes, then small edge cases."""
    import torch

    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    geo = bsa_geometries(tokens_per_frame)
    Sq, Sk, nc = geo["default"]
    fSq, fSk, fnc = geo["fast_decode"]
    cases = []
    for top_k in (8, 10):
        for int8 in (False, True):
            cases.append(check_bsa_case(fa, bsa, f"default_top{top_k}", 2, H, Sq, Sk, D,
                                        top_k=top_k, ncond=nc, qk_int8=int8,
                                        timed=True, seed=30 + top_k))
            torch.cuda.empty_cache()
    for int8 in (False, True):
        cases.append(check_bsa_case(fa, bsa, "fast_decode_top6", 2, H, fSq, fSk, D,
                                    top_k=6, ncond=fnc, qk_int8=int8, timed=True, seed=41))
    cases.append(check_bsa_case(fa, bsa, "all_blocks_vs_flash_fwd", 2, H, Sq, Sk, D,
                                top_k=-(-Sk // 1024), ncond=nc, seed=42, dense_check=True))
    torch.cuda.empty_cache()
    small = [
        ("ragged_sq_sk", dict(B=1, H=3, Sq=200, Sk=333, D=64, top_k=3, block_q=128,
                              block_k=64, ncond=64)),
        ("kv_valid", dict(B=2, H=2, Sq=256, Sk=640, D=128, top_k=4, block_q=128,
                          block_k=128, ncond=128, kv_valid=400)),
        ("fp16", dict(B=1, H=2, Sq=256, Sk=640, D=128, top_k=3, block_q=128,
                      block_k=128, ncond=128, dtype_name="float16")),
        ("d32_blocks32", dict(B=2, H=2, Sq=96, Sk=160, D=32, top_k=3, block_q=32,
                              block_k=32, ncond=32)),
        ("d64_blocks512", dict(B=1, H=2, Sq=1000, Sk=2600, D=64, top_k=4, block_q=512,
                               block_k=512, ncond=1024)),
        ("no_valid_key", dict(B=1, H=2, Sq=64, Sk=128, D=64, top_k=2, block_q=32,
                              block_k=64, kv_valid=0)),
    ]
    for i, (name, kw) in enumerate(small):
        kw = dict(kw)
        B, Hs, Sq_, Sk_, D_ = (kw.pop(key) for key in ("B", "H", "Sq", "Sk", "D"))
        for int8 in (False, True):
            cases.append(check_bsa_case(fa, bsa, name, B, Hs, Sq_, Sk_, D_, qk_int8=int8,
                                        seed=50 + i, **kw))
    sums = [check_block_sum_case(bsa, "pool_q", 2, Sq, H, D, 1024, timed=True, seed=60),
            check_block_sum_case(bsa, "pool_k", 2, Sk, H, D, 1024, timed=True, seed=61),
            check_block_sum_case(bsa, "ragged_fp16", 1, 1000, 3, 64, 384,
                                 dtype_name="float16", seed=62),
            check_block_sum_case(bsa, "blocks32_d32", 2, 150, 2, 32, 32, seed=63)]
    for c in cases + sums:
        print("[bsa-kernel] " + json.dumps(c))
    return cases, sums


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

    # the decode levers: 5 cond + 9 generated frames of 64x128 give 2 + 3
    # latents of 32 tokens, Sk = 160 in 5 blocks of 32: top_k 4 keeps the
    # 2 cond blocks and the diagonal and chooses 1 of the 2 others
    from longcat_video_tta_tpu_torch.config import BSAConfig, CFGReuseConfig, PABConfig
    from longcat_video_tta_tpu_torch.ops import bsa

    noise = torch.from_numpy(rng.standard_normal((1, 16, 3, 8, 16)).astype(np.float32))
    kw = dict(num_frames=9, num_inference_steps=4, init_noise=noise,
              bsa_cfg=BSAConfig(keep_ratio=0.5, block_q=32, block_k=32),
              quantize_decode="int8qk", pab_cfg=PABConfig(every=2),
              cfgr_cfg=CFGReuseConfig(every=2))
    a = generate_vc(cpu, cond, "a ball moving across the scene", **kw)
    bsa.reset_launches()
    b = generate_vc(gpu, cond, "a ball moving across the scene", **kw)
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    psnr = float("inf") if mse == 0 else -10 * math.log10(mse)
    print(f"[agree] longcat_demo generate_vc with BSA (keep 0.5, blocks 32), int8qk, "
          f"PAB every 2, CFG reuse every 2, card vs cpu: shape {b.shape}, max|diff| "
          f"{float(np.abs(a - b).max()):.4g}, psnr {psnr:.2f} dB (min {E2E_PSNR_MIN}); "
          f"bsa_fwd_qk_int8 launches {bsa.bsa_int8_launches}")
    if not (np.isfinite(b).all() and psnr >= E2E_PSNR_MIN and bsa.bsa_int8_launches > 0):
        raise AssertionError("card and CPU generate_vc with decode levers disagree")


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


# decode-lever main paths: the runner's default request (28 generated
# frames at 480x832) with 8 denoising steps (not 50), 2 requests each
LEVER = dict(height=480, width=832, gen_frames=28, steps=8, guidance=4.0, requests=2)
LEVER_RUNS = {
    # 16-bit BSA at keep 0.5 (top_k 10 of 19 blocks: 7 cond + diagonal +
    # 2 chosen), plus one dense generation for the fidelity record
    "A": dict(cond_frames=14, flags=["--bsa-keep-ratio", "0.5",
                                     "--fast-decode-verify", "1"]),
    # W8A8 + int8-QK BSA at keep 0.35 (top_k 6 of 16) + PAB every 4 and
    # CFG reuse every 2 over [0.06, 0.96), in 4-step segments
    "B": dict(cond_frames=5, flags=["--fast-decode", "--quantize-decode", "int8qk",
                                    "--gen-segment-steps", "4"]),
}


def lever_launches(run: str, depth: int):
    """Launches per kernel that a lever run implies for its 2 requests.
    Per request: the cond-cache precompute runs self- and cross-attention
    on the forward kernel (2 x depth); each denoising step runs
    cross-attention (depth) on it, and self-attention through the BSA
    kernel (depth, two block sums each) on the steps that compute
    attention: every step in run A; in run B the steps PAB does not
    reuse, i = 0 and 4 of 8 (every 4 from round(0.06 * 8) = 0 to
    round(0.96 * 8) = 8). CFG reuse halves the batch of steps 1, 3, 5, 7
    but not the launch count. Run A's verify generation (request 0 only)
    is dense: 2 x depth per step and for the cond cache."""
    steps, n = LEVER["steps"], LEVER["requests"]
    if run == "A":
        attn_steps = steps
        extra_fwd = 2 * depth * (1 + steps)
    else:
        start, end, every = round(0.06 * steps), round(0.96 * steps), 4
        attn_steps = sum(1 for i in range(steps)
                         if not (start <= i < end and (i - start) % every))
        extra_fwd = 0
    name = "bsa_fwd" if run == "A" else "bsa_fwd_qk_int8"
    other = "bsa_fwd_qk_int8" if run == "A" else "bsa_fwd"
    return {"flash_fwd": n * (2 * depth + depth * steps) + extra_fwd,
            name: n * depth * attn_steps, other: 0,
            "bsa_block_sum": n * 2 * depth * attn_steps}


def phase_lever_path(fa, bsa, run: str, depth: int):
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.runners import run_tta

    spec = LEVER_RUNS[run]
    out_dir = os.path.join(RUN_DIR, f"lever_{run}")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--method", "none", "--preset", "longcat_13b",
            "--synthetic", str(LEVER["requests"]), "--output-dir", out_dir,
            "--device", "cuda", "--height", str(LEVER["height"]),
            "--width", str(LEVER["width"]),
            "--num-cond-frames", str(spec["cond_frames"]),
            "--num-frames", str(LEVER["gen_frames"]),
            "--num-inference-steps", str(LEVER["steps"]),
            "--guidance-scale", str(LEVER["guidance"]), "--no-save-videos",
            *spec["flags"]]
    print(f"[lever {run}] run_tta " + " ".join(argv))
    print(f"[lever {run}] cuts: 8 denoising steps (not 50), 2 requests; full depth "
          f"{depth} and widths")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    bsa.reset_launches()
    t0 = time.time()
    summary = run_tta.main(argv)
    wall = time.time() - t0
    got = {"flash_fwd": fa.launches, "bsa_fwd": bsa.bsa_launches,
           "bsa_fwd_qk_int8": bsa.bsa_int8_launches,
           "bsa_block_sum": bsa.bsa_block_sum_launches}
    shutil.rmtree(os.path.join(out_dir, "synthetic_data"), ignore_errors=True)
    for i, r in enumerate(summary["results"]):
        print(f"[lever {run}] request {i}: success={r['success']} "
              f"gen_time={r.get('gen_time')} s total_time={r.get('total_time')} s "
              f"psnr={r.get('psnr')} ssim={r.get('ssim')}"
              + (f" fast_decode_verify={json.dumps(r['fast_decode_verify'])}"
                 if "fast_decode_verify" in r else "")
              + (f" error={r['error']}" if "error" in r else ""))
    expected = lever_launches(run, depth)
    print(f"[lever {run}] wall {wall:.1f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got} "
          f"(expected {expected}); summary fast_decode_verify "
          f"{json.dumps(summary['fast_decode_verify'])}")
    if summary["num_success"] != LEVER["requests"]:
        raise AssertionError(f"lever run {run}: {summary['num_success']}/"
                             f"{LEVER['requests']} requests succeeded")
    for r in summary["results"]:
        if not (np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])):
            raise AssertionError(f"non-finite metrics: {r}")
    if run == "A":
        fdv = summary["fast_decode_verify"]
        if not (fdv and np.isfinite(fdv.get("psnr_fast_vs_dense_mean", np.nan))):
            raise AssertionError(f"run A: no finite fast_decode_verify record: {fdv}")
    if got != expected:
        raise AssertionError(f"kernel launches on lever run {run} {got}, "
                             f"expected {expected}")
    return got, [r.get("gen_time") for r in summary["results"]]


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


def print_build(fa):
    for path, log, seconds in fa.build_libraries():
        print(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"[build] {line.split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")


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
    from longcat_video_tta_tpu_torch.ops import bsa
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

    t_start = time.time()

    def timed_phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        torch.cuda.empty_cache()
        print(f"[time] {name} {time.time() - t0:.1f} s")
        return out

    timed_phase("build", print_build, fa)
    cfg = longcat_13b()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tokens_per_frame = (MAIN["height"] // sf) * (MAIN["width"] // sf)
    cases = timed_phase("kernel check", phase_kernel_checks, fa, cfg.dit, tokens_per_frame)
    bwd_cases = timed_phase("backward kernel check", phase_bwd_kernel_checks, fa, cfg.dit,
                            tokens_per_frame)
    bsa_cases, sum_cases = timed_phase("bsa kernel check", phase_bsa_kernel_checks, fa,
                                       bsa, cfg.dit, tokens_per_frame)
    timed_phase("small-input agreement", phase_small_agreement)
    timed_phase("step agreement", phase_step_agreement)
    serving_launches, serving_gen = timed_phase("main path", phase_main_path, fa,
                                                cfg.dit.depth)
    tta = timed_phase("delta_a path", phase_tta_path, fa, cfg.dit.depth)
    levers = {}
    for run in LEVER_RUNS:
        levers[run], gen_times = timed_phase(f"lever run {run}", phase_lever_path, fa, bsa,
                                             run, cfg.dit.depth)
        print(f"[lever {run}] gen_time per request {gen_times} s; dense serving path "
              f"(5 cond, 8 generated frames, 4 steps) {[g for g, _ in serving_gen]} s")
    print(f"[time] all phases {time.time() - t_start:.1f} s")

    def entry(name, source, replaces, launches, all_cases):
        timed = next(c for c in all_cases if "ms" in c)
        return {"name": name, "route": "cuda",
                "source": f"longcat_video_tta_tpu_torch/csrc/{source}",
                "replaces": f"longcat_video_tta_tpu/ops/{replaces}",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in all_cases),
                **{key: timed[key] for key in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}}

    by_kernel = lambda name: [c for c in bwd_cases if c["kernel"] == name]
    bsa_kernel = lambda name: [c for c in bsa_cases if c["kernel"] == name]
    lever_sum = lambda name: sum(levers[run][name] for run in levers)
    kernels = [
        entry("flash_fwd", "flash_fwd.cu", "flash_attention.py:133",
              serving_launches + tta["flash_fwd"] + lever_sum("flash_fwd"), cases),
        entry("flash_bwd_dq", "flash_bwd.cu", "flash_attention.py:327",
              tta["flash_bwd_dq"], by_kernel("flash_bwd_dq")),
        entry("flash_bwd_dkv", "flash_bwd.cu", "flash_attention.py:261",
              tta["flash_bwd_dkv"], by_kernel("flash_bwd_dkv")),
        entry("bsa_block_sum", "bsa.cu", "bsa.py:120", lever_sum("bsa_block_sum"),
              sum_cases),
        entry("bsa_fwd", "bsa.cu", "bsa.py:159", lever_sum("bsa_fwd"),
              bsa_kernel("bsa_fwd")),
        entry("bsa_fwd_qk_int8", "bsa.cu", "bsa.py:159", lever_sum("bsa_fwd_qk_int8"),
              bsa_kernel("bsa_fwd_qk_int8")),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
