#!/usr/bin/env python3
"""How much the flash-attention gates catch: each kernel, and any variant
of its source, against the plain version at the main path's shapes.

    python3 scripts/torch_kernel_tolerance.py [--source FILE ...] [--bwd-source FILE ...]
        [--bsa-source FILE ...]

Forward (``--source``, default the package's csrc/flash_fwd.cu): each
source runs on the attention shapes of chip_smoke.py's serving path
(decode self-attention, cross-attention, the prefix-masked no-cache
self-attention, and the decode at the runner's default geometry) on
seeded bf16 inputs; one JSON line per (source, case) gives the errors
against ``attention_reference``, chip_smoke's gates and whether they
hold (``ok``), and whether a fixed absolute gate on o (max|o err| <=
1e-2, for comparison) holds.

Backward (``--bwd-source``, default the package's csrc/flash_bwd.cu):
each source's dQ and dK/dV kernels run on the delta_a train step's
shapes (the 10 920-token self-attention with its 6240-token prefix, and
the cross-attention against 512 text tokens), from the sound forward
kernel's o and lse; one JSON line per (source, case, output) gives the
error against ``attention_backward_reference`` and chip_smoke's gates.

BSA (``--bsa-source``, default the package's csrc/bsa.cu): each source's
gathered-attention kernel, 16-bit and int8-QK, runs on the decode shapes
of chip_smoke.py's lever runs (the runner's default geometry with top_k
8 and 10, and the --fast-decode geometry with top_k 6) over one selection
made by the package's own kernels; one JSON line per (source, case,
variant) gives the error against ``bsa_reference`` and chip_smoke's BSA
gates.

A variant with a planted fault (made by sed on a copy of a source) shows
which faults each gate catches. The plain versions run once per case and
every source is held to them. With some of the three options, only those
parts run; with none, all three run on the package's sources. Needs a
CUDA GPU; imports only the port. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "longcat_video_tta_tpu_torch", "csrc")
DEFAULT_SOURCE = os.path.join(CSRC, "flash_fwd.cu")
DEFAULT_BWD_SOURCE = os.path.join(CSRC, "flash_bwd.cu")
DEFAULT_BSA_SOURCE = os.path.join(CSRC, "bsa.cu")
FIXED_TOL = 1e-2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="forward kernel source to hold to the plain version "
                         "(repeatable)")
    ap.add_argument("--bwd-source", action="append", default=[],
                    help="backward kernel source to hold to the plain version "
                         "(repeatable)")
    ap.add_argument("--bsa-source", action="append", default=[],
                    help="block-sparse kernel source to hold to the plain versions "
                         "(repeatable)")
    args = ap.parse_args()
    if not (args.source or args.bwd_source or args.bsa_source):
        args.source, args.bwd_source = [DEFAULT_SOURCE], [DEFAULT_BWD_SOURCE]
        args.bsa_source = [DEFAULT_BSA_SOURCE]
    sources = [os.path.abspath(s) for s in args.source]
    bwd_sources = [os.path.abspath(s) for s in args.bwd_source]
    bsa_sources = [os.path.abspath(s) for s in args.bsa_source]

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from longcat_video_tta_tpu_torch.config import longcat_13b
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    everything = sources + bwd_sources + bsa_sources + [DEFAULT_SOURCE, DEFAULT_BSA_SOURCE]
    for src, (_, _, seconds) in zip(everything, fa.build_libraries(everything)):
        print(f"[build] {src} in {seconds:.1f} s")

    cfg = longcat_13b()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tokens_per_frame = (cs.MAIN["height"] // sf) * (cs.MAIN["width"] // sf)
    for name, shape, opts in (cs.main_path_cases(cfg.dit, tokens_per_frame)
                              if sources else []):
        opts = dict(opts)
        ncond = opts.pop("ncond", 0)
        q, k, v = cs.case_inputs(*shape, **opts)
        o_ref, lse_ref = cs.reference(fa, q, k, v, ncond, None)
        for src in sources:
            fa.load_library(src)
            o, lse = fa.flash_attention(q, k, v, num_cond_tokens=ncond)
            e = cs.kernel_errors(o, lse, o_ref, lse_ref, "bfloat16")
            e["fixed_tol"] = FIXED_TOL
            e["fixed_gate_ok"] = (e["max_abs_err"] <= FIXED_TOL
                                  and e["max_abs_err_lse"] <= cs.LSE_TOL)
            print(json.dumps({"source": os.path.relpath(src, ROOT), "case": name,
                              "shape": shape, **e}))
            del o, lse
        del q, k, v, o_ref, lse_ref
        torch.cuda.empty_cache()
    if bwd_sources:
        check_backward(cs, fa, cfg.dit, tokens_per_frame, bwd_sources)
    if bsa_sources:
        check_bsa(cs, fa, cfg.dit, tokens_per_frame, bsa_sources)
    return 0


def check_bsa(cs, fa, dit_cfg, tokens_per_frame, bsa_sources):
    import torch

    from longcat_video_tta_tpu_torch.ops import bsa

    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    geo = cs.bsa_geometries(tokens_per_frame)
    # (name, (B, H, Sq, Sk, D), top_k, block, cond tokens, kv_valid, seed):
    # the lever runs' shapes, then the small ragged and kv_valid cases of
    # chip_smoke, where a block's invalid tail is a large share of its keys
    cases = [("default_top8", (2, H, *geo["default"][:2], D), 8, 1024,
              geo["default"][2], None, 31),
             ("default_top10", (2, H, *geo["default"][:2], D), 10, 1024,
              geo["default"][2], None, 32),
             ("fast_decode_top6", (2, H, *geo["fast_decode"][:2], D), 6, 1024,
              geo["fast_decode"][2], None, 33),
             ("ragged_sq_sk", (1, 3, 200, 333, 64), 3, 64, 64, None, 34),
             ("kv_valid", (2, 2, 256, 640, 128), 4, 128, 128, 400, 35)]
    for name, shape, top_k, blk, ncond, kvv, seed in cases:
        B, Hc, Sq, Sk, Dc = shape
        q, k, v = cs.case_inputs(B, Hc, Sq, Sk, Dc, seed=seed)
        bsa.load_library(DEFAULT_BSA_SOURCE)  # the selection by the sound kernels
        idx = bsa.select_blocks(q, k, block_q=max(blk, 128), block_k=blk, top_k=top_k,
                                num_cond_tokens=ncond, q_token_offset=Sk - Sq,
                                kv_valid=kvv)
        for int8 in (False, True):
            kw = dict(block_q=max(blk, 128), block_k=blk, qk_int8=int8, kv_valid=kvv)
            o_ref = bsa.bsa_reference(q, k, v, idx, **kw)
            for src in bsa_sources:
                bsa.load_library(src)
                o = bsa.bsa_forward(q, k, v, idx, **kw)
                e = cs.bsa_errors(o, o_ref, "bfloat16", int8)
                e["rel_l2"] = e["l2_err"] / float(o_ref.float().norm())
                print(json.dumps({"source": os.path.relpath(src, ROOT), "case": name,
                                  "variant": "int8" if int8 else "16-bit",
                                  "shape": shape, "top_k": top_k, **e}))
                del o
            del o_ref
        del q, k, v, idx
        torch.cuda.empty_cache()


def check_backward(cs, fa, dit_cfg, tokens_per_frame, bwd_sources):
    import torch

    fa.load_library(DEFAULT_SOURCE)  # o and lse from the sound forward
    n_cond_lat, n_train_lat, _ = cs.tta_split()
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    cases = [("train_self", (1, H, s_train, s_train, D),
              dict(ncond=n_cond_lat * tokens_per_frame, seed=21)),
             ("train_cross", (1, H, s_train, dit_cfg.text_len, D),
              dict(fused_kv=True, seed=22))]
    for name, shape, opts in cases:
        opts = dict(opts)
        ncond = opts.pop("ncond", 0)
        seed = opts["seed"]
        q, k, v = cs.case_inputs(*shape, **opts)
        g = torch.Generator(device="cuda").manual_seed(seed + 100)
        do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        kw = dict(num_cond_tokens=ncond)
        o, lse = fa.flash_attention(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        refs = cs.backward_reference(fa, q, k, v, o, lse, do, ncond, None)
        for src in bwd_sources:
            fa.load_library(src)
            got = ((fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),)
                   + fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
            for oname, d, d_ref in zip(("dq", "dk", "dv"), got, refs):
                e = cs.grad_errors(d, d_ref, "bfloat16")
                e["rel_l2"] = e["l2_err"] / (e["l2_tol"] / (cs.GRAD_L2_EPS
                                                            * cs.O_EPS["bfloat16"]))
                print(json.dumps({"source": os.path.relpath(src, ROOT), "case": name,
                                  "shape": shape, "output": oname, **e}))
            del got
        del q, k, v, do, o, lse, delta, refs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
