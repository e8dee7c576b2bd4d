#!/usr/bin/env python3
"""Where one request's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 scripts/torch_profile_request.py [--depth 48] [--steps 4]

Builds the LongCat-13.6B-width bundle (random bf16 weights drawn on the
card), makes one synthetic 480x832 clip, runs one warm-up request and
then:
  1. times each phase of one ``generate_vc`` call from the call itself:
     its ``on_phase`` hook records a CUDA event on the stream as each
     phase begins (VAE encode, prompt encodes, cond-cache precompute,
     each denoising step, VAE decode with the copy to the host), and a
     phase's time is the stream time between its event and the next;
  2. profiles one more whole ``generate_vc`` call with torch.profiler and
     prints the device's busy and idle share and the kernels by total
     device time (the flash_fwd kernel among them).
Only the port is imported (no JAX). Prints the card's name and power
limit first. Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=48)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cond-frames", type=int, default=5)
    ap.add_argument("--gen-frames", type=int, default=8)
    args = ap.parse_args()

    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from longcat_video_tta_tpu_torch.config import longcat_13b
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = longcat_13b()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, depth=args.depth))
    fa.build_library()
    bundle, t_init = _sync_time(lambda: ModelBundle.init_random(cfg, seed=0))
    print(f"[init] {t_init:.2f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    H, W = 480, 832
    rng = np.random.default_rng(0)
    cond = rng.uniform(-1, 1, (1, 3, args.cond_frames, H, W)).astype(np.float32)
    prompt = "a ball moving across the scene"
    kw = dict(num_frames=args.gen_frames, num_inference_steps=args.steps)
    _, t_warm = _sync_time(lambda: generate_vc(bundle, cond, prompt, **kw))
    print(f"[warm-up request] {t_warm:.3f} s")

    # ---- per-phase times, from the hook of one real request ------------
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    _, t_req = _sync_time(lambda: generate_vc(bundle, cond, prompt,
                                              on_phase=on_phase, **kw))
    phases = {}
    for (name, ev), (_, nxt) in zip(marks, marks[1:]):
        phases.setdefault(name, []).append(ev.elapsed_time(nxt))
    print(f"[request] {t_req * 1e3:.1f} ms wall; stream time "
          f"{marks[0][1].elapsed_time(marks[-1][1]):.1f} ms")
    for name, ts in phases.items():
        print(f"[phase] {name:14s} {sum(ts):10.1f} ms"
              + (f" ({len(ts)} x, each {', '.join(f'{t:.1f}' for t in ts)})"
                 if len(ts) > 1 else ""))

    # ---- profiled request -----------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    fa.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_req = _sync_time(lambda: generate_vc(bundle, cond, prompt, **kw))
    print(f"[profiled request] {t_req:.3f} s wall, flash_fwd launches {fa.launches}")
    # device kernels only (CPU ops and runtime markers such as "Command
    # Buffer Full" also carry device-side totals in key_averages)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if e.device_type == cuda and "Command Buffer" not in e.name]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:  # union of kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    print(f"[device] busy {busy_us / 1e3:.1f} ms of {t_req * 1e3:.1f} ms wall "
          f"(idle share {1 - busy_us / 1e6 / t_req:.3f}); {len(kernels)} kernels")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    total = sum(t for t, _ in by_name.values())
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[kernel] {t / 1e3:10.1f} ms {100 * t / max(total, 1):5.1f}% "
              f"x{n:<6d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
