#!/usr/bin/env python3
"""Time design variants of the Hopper attention kernels against the
package's own, on one CUDA GPU, in one process.

    python3 scripts/torch_kernel_variants.py [--variant NAME ...]

A variant is a deterministic edit of a copy of the package's kernel
sources (VARIANTS below), built beside the package's sources. The shapes
of the kernels a variant changes run in the order package, variants,
variants reversed, package, 10 timed calls each (CUDA events), so that
drift of the card's clock shows as a spread between the two runs of one
source: forward and BSA variants on each forward shape of chip_smoke.py's
serving path and the run-A BSA shape (default geometry, top_k 10, 16-bit
and int8-QK); backward variants on the delta_a train step's shapes
(dQ and dK/dV of the 10 920-token self-attention, dQ of its
cross-attention). Each line gives the time and the largest difference
from the package kernel's output on the same inputs (a variant that
changes only the schedule gives 0). Prints the card's name and power
limit first; imports only the port.

Variants:
  pingpong  (forward, BSA) the two consumer warpgroups take turns at the
            tensor cores: before issuing a tile's products a consumer
            waits on its named barrier, and after issuing them it arrives
            on the other's, so one consumer's softmax runs under the
            other's products.
  dq_bk64   (backward) the dQ kernel walks 64-key tiles of K and V
            instead of 128-key ones: half the registers for S and dP,
            twice the tiles and barrier round trips.
  kv_stages3 (backward) the dK/dV kernel's ring of Q and dO tiles has 3
            slots instead of 2.
  bwd_queued (backward) each consumer of both kernels issues the next
            tile's S and dP products right behind a tile's last product
            (dV and dK, or dQ) instead of waiting for it first.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "longcat_video_tta_tpu_torch", "csrc")
H = "hopper_common.cuh"
_DEALLOC = ('__device__ __forceinline__ void reg_dealloc() {\n'
            '  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(R));\n}\n')
B = "flash_bwd.cu"
# name -> (the part it changes, [(file, text, replacement)])
VARIANTS = {
    "pingpong": ("fwd", [
        (H, _DEALLOC, _DEALLOC + (
            '\n__device__ __forceinline__ void bar_sync(int id) {\n'
            '  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");\n}\n'
            '\n__device__ __forceinline__ void bar_arrive(int id) {\n'
            '  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");\n}\n')),
        # consumer 0 takes the first turn
        (H, "      mbar_wait(q_full, 0);\n",
         "      mbar_wait(q_full, 0);\n      if (cw == 1 && n_tiles > 1) bar_arrive(1);\n"),
        (H, "        mbar_wait(k_full + st, (t / STAGES) & 1);\n",
         "        mbar_wait(k_full + st, (t / STAGES) & 1);\n        bar_sync(1 + cw);\n"),
        (H, "        issue_rs<T, D, BK>(o, p, sv + pst * L::V_BYTES);\n        wgmma_commit();\n",
         "        issue_rs<T, D, BK>(o, p, sv + pst * L::V_BYTES);\n        wgmma_commit();\n"
         "        if (cw == 0 || t + 1 < n_tiles) bar_arrive(2 - cw);\n"),
    ]),
    "dq_bk64": ("bwd", [(B, "constexpr int DQ_BK = 128;", "constexpr int DQ_BK = 64;")]),
    "kv_stages3": ("bwd", [(B, "constexpr int KV_STAGES = 2;", "constexpr int KV_STAGES = 3;")]),
    "bwd_queued": ("bwd", [
        (B, "        const int st = t % KV_STAGES;\n        fence_regs(dk);\n        fence_regs(dv);\n"
            "        wgmma_fence();\n        issue_sdp(t);\n",
         "        const int st = t % KV_STAGES;\n"),
        (B, "      mbar_wait(kv_full, 0);\n", "      mbar_wait(kv_full, 0);\n      wgmma_fence();\n"
                                            "      issue_sdp(0);\n"),
        (B, "        wgmma_wait<0>();\n        fence_regs(dk);\n",
         "        if (t + 1 < sc.count()) {\n          issue_sdp(t + 1);\n          wgmma_wait<2>();\n"
         "        } else {\n          wgmma_wait<0>();\n        }\n        fence_regs(dk);\n"),
        (B, "        const int st = t % DQ_STAGES;\n        fence_regs(dq);\n        wgmma_fence();\n"
            "        issue_sdp(t);\n",
         "        const int st = t % DQ_STAGES;\n"),
        (B, "      mbar_wait(q_full, 0);\n", "      mbar_wait(q_full, 0);\n      wgmma_fence();\n"
                                           "      issue_sdp(0);\n"),
        (B, "        wgmma_wait<0>();\n        fence_regs(dq);\n",
         "        if (t + 1 < sc.count()) {\n          issue_sdp(t + 1);\n          wgmma_wait<2>();\n"
         "        } else {\n          wgmma_wait<0>();\n        }\n        fence_regs(dq);\n"),
    ]),
}


def make_variant(name: str) -> str:
    """Copy the package's kernel sources into a directory of their own,
    apply variant ``name`` and return that directory."""
    out = os.path.join(tempfile.gettempdir(), f"lc_variant_{name}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for f in os.listdir(CSRC):
        if not f.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(CSRC, f)) as fh:
            src = fh.read()
        for fname, text, new in VARIANTS[name][1]:
            if fname == f:
                if src.count(text) != 1:
                    raise ValueError(f"variant {name}: {f} holds {text!r} "
                                     f"{src.count(text)} times, not once")
                src = src.replace(text, new)
        if f.endswith(".cu"):  # a library of its own, whatever file changed
            src += f"\n// variant: {name}\n"
        with open(os.path.join(out, f), "w") as fh:
            fh.write(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="variant to time beside the package's kernels (repeatable; "
                         "default all)")
    args = ap.parse_args()
    names = args.variant or sorted(VARIANTS)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from longcat_video_tta_tpu_torch.config import longcat_13b
    from longcat_video_tta_tpu_torch.ops import bsa
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dirs = {"package": CSRC, **{n: make_variant(n) for n in names}}
    srcs = [os.path.join(d, f) for d in dirs.values()
            for f in ("flash_fwd.cu", "bsa.cu", "flash_bwd.cu")]
    for src, (_, log, seconds) in zip(srcs, fa.build_libraries(srcs)):
        spills = [line.strip() for line in log.splitlines()
                  if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line))
                  and (int(m.group(1)) or int(m.group(2)))]
        print(f"[build] {os.path.relpath(src, ROOT) if src.startswith(ROOT) else src} "
              f"in {seconds:.1f} s; spills: {spills or 'none'}")

    cfg = longcat_13b()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tokens_per_frame = (cs.MAIN["height"] // sf) * (cs.MAIN["width"] // sf)
    part_order = {}
    for part in ("fwd", "bwd"):
        sel = ["package"] + [n for n in names if VARIANTS[n][0] == part]
        part_order[part] = sel + sel[::-1] if len(sel) > 1 else []
    if part_order["bwd"]:
        time_backward(cs, fa, cfg.dit, tokens_per_frame, dirs, part_order["bwd"])
    order = part_order["fwd"]
    if not order:
        return 0
    for case, shape, opts in cs.main_path_cases(cfg.dit, tokens_per_frame):
        opts = dict(opts)
        ncond = opts.pop("ncond", 0)
        q, k, v = cs.case_inputs(*shape, **opts)
        run = lambda: fa.flash_attention(q, k, v, num_cond_tokens=ncond)[0]
        base = None
        for n in order:
            fa.load_library(os.path.join(dirs[n], "flash_fwd.cu"))
            o = run()
            base = o if base is None else base
            diff = float((o.float() - base.float()).abs().max())
            print(f"[variant] flash_fwd {case:30s} {n:10s} {cs._events_ms(run, iters=10):9.3f} ms"
                  f"  max|o - package| {diff:.3g}")
        del q, k, v, base, o
        torch.cuda.empty_cache()

    Sq, Sk, nc = cs.bsa_geometries(tokens_per_frame)["default"]
    q, k, v = cs.case_inputs(2, cfg.dit.num_heads, Sq, Sk, cfg.dit.head_dim, seed=40)
    idx = bsa.select_blocks(q, k, block_q=1024, block_k=1024, top_k=10, num_cond_tokens=nc,
                            q_token_offset=Sk - Sq)
    for int8 in (False, True):
        run = lambda: bsa.bsa_forward(q, k, v, idx, block_q=1024, block_k=1024, qk_int8=int8)
        base = None
        for n in order:
            bsa.load_library(os.path.join(dirs[n], "bsa.cu"))
            o = run()
            base = o if base is None else base
            diff = float((o.float() - base.float()).abs().max())
            kname = "bsa_fwd_qk_int8" if int8 else "bsa_fwd"
            print(f"[variant] {kname:15s} default_top10 {n:10s} "
                  f"{cs._events_ms(run, iters=10):9.3f} ms  max|o - package| {diff:.3g}")
    fa.load_library(os.path.join(CSRC, "flash_fwd.cu"))
    bsa.load_library(os.path.join(CSRC, "bsa.cu"))
    return 0


def time_backward(cs, fa, dit_cfg, tokens_per_frame, dirs, order):
    """The dQ and dK/dV kernels of each source at the train step's self-
    attention, and dQ at its cross-attention, from the sound forward's o
    and lse; the lse and delta rows are laid out once, outside the timing."""
    import torch

    fa.load_library(os.path.join(CSRC, "flash_fwd.cu"))
    n_cond_lat, n_train_lat, _ = cs.tta_split()
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    cases = [("train_self", (1, H, s_train, s_train, D),
              dict(ncond=n_cond_lat * tokens_per_frame, seed=21), (False, True)),
             ("train_cross", (1, H, s_train, dit_cfg.text_len, D),
              dict(fused_kv=True, seed=22), (False,))]
    for case, shape, opts, kinds in cases:
        opts = dict(opts)
        ncond = opts.pop("ncond", 0)
        q, k, v = cs.case_inputs(*shape, **opts)
        g = torch.Generator(device="cuda").manual_seed(opts["seed"] + 100)
        do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        o, lse = fa.flash_attention(q, k, v, num_cond_tokens=ncond)
        rows = fa.backward_rows(lse, do=do, o=o)
        for dkv in kinds:
            run = lambda: fa._kernel_backward(dkv, q, k, v, do, *rows, num_cond_tokens=ncond)
            base = None
            for n in order:
                fa.load_library(os.path.join(dirs[n], "flash_bwd.cu"))
                out = run()
                base = out if base is None else base
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(out, base))
                kname = "flash_bwd_dkv" if dkv else "flash_bwd_dq"
                print(f"[variant] {kname:15s} {case:12s} {n:10s} "
                      f"{cs._events_ms(run, iters=10):9.3f} ms  max|d - package| {diff:.3g}")
        del q, k, v, do, o, lse, rows, base, out
        torch.cuda.empty_cache()
    fa.load_library(os.path.join(CSRC, "flash_bwd.cu"))


if __name__ == "__main__":
    sys.exit(main())
