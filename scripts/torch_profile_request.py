#!/usr/bin/env python3
"""Where one request's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 scripts/torch_profile_request.py [--method none|delta_a] [--depth 48]
        [--steps N --cond-frames N --gen-frames N] [run_tta decode-lever flags]

LongCat-13.6B width (random bf16 weights drawn on the card), 480x832
synthetic clips. Phase times come from the serving code's own
``on_phase`` hooks: each records a CUDA event on the stream as a phase
begins, and a phase's time is the stream time between its event and the
next.

``--method none`` (default): one ``generate_vc`` call after a warm-up
request: VAE encode, prompt encodes, cond-cache precompute, each
denoising step, VAE decode with the copy to the host. Any other flag is
one of run_tta's decode levers (for example ``--bsa-keep-ratio 0.5`` or
``--fast-decode --quantize-decode int8qk``): the runner's own parser and
``apply_fast_decode_defaults`` turn them into generate_vc's arguments.

``--method delta_a``: the runner (``run_tta.main``) on 3 videos with the
chip_smoke TTA geometry (29-frame window, 6 AdamW steps, anchor check
every 3, 4 denoising steps); video 0 warms up, video 1 gives the phase
times (window encode, stopper setup anchor, each train chunk and anchor
check, generation and its sub-phases), and video 2 is profiled.

Then one more request (none) or video (delta_a) runs under
torch.profiler, and the script prints the device's busy and idle share
and the kernels by total device time, then by kind (the port's flash and
BSA kernels, library GEMMs, convolutions, everything else).
Only the port is imported (no JAX). Prints the card's name and power
limit first. Writes only the runner's own output directory under
.chip_smoke/ (delta_a).
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


def device_breakdown(prof, wall_s: float) -> None:
    """Busy and idle share of the card and the top kernels, from the
    kernel events of a torch.profiler run (CPU ops and runtime markers
    such as "Command Buffer Full" also carry device-side totals in
    key_averages, so only kernel events are counted)."""
    import torch

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
    print(f"[device] busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
          f"(idle share {1 - busy_us / 1e6 / wall_s:.3f}); {len(kernels)} kernels")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    total = sum(t for t, _ in by_name.values())
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[kernel] {t / 1e3:10.1f} ms {100 * t / max(total, 1):5.1f}% "
              f"x{n:<6d} {name[:110]}")
    kinds = {}
    for name, (t, n) in by_name.items():
        k = kernel_kind(name)
        kt, kn = kinds.get(k, (0.0, 0))
        kinds[k] = (kt + t, kn + n)
    for k, (t, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"[kind] {k:12s} {t / 1e3:10.1f} ms {100 * t / max(total, 1):5.1f}% x{n}")


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel by its name: the port's own
    attention kernels, library GEMMs (cuBLAS/cuBLASLt, 16-bit and int8),
    convolutions, and everything else (elementwise, reductions, copies)."""
    if "bsa_fwd" in name or "block_sum" in name:
        return "bsa"
    if "flash_" in name:
        return "flash"
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "imma", "_mma_")):
        return "gemm"
    if "conv" in low or "implicit" in low:
        return "conv"
    return "elementwise"


def print_phases(marks):
    """Print and return the stream time of each phase (ms per occurrence),
    from (name, event) marks in order."""
    phases = {}
    for (name, ev), (_, nxt) in zip(marks, marks[1:]):
        phases.setdefault(name, []).append(ev.elapsed_time(nxt))
    print(f"[phases] stream time {marks[0][1].elapsed_time(marks[-1][1]):.1f} ms")
    for name, ts in phases.items():
        print(f"[phase] {name:14s} {sum(ts):10.1f} ms"
              + (f" ({len(ts)} x, each {', '.join(f'{t:.1f}' for t in ts)})"
                 if len(ts) > 1 else ""))
    return phases


def profile_delta_a(args) -> int:
    """Phase times of one delta_a video and a profile of the next, both
    from the runner's own on_phase hook."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa
    from longcat_video_tta_tpu_torch.runners import run_tta

    T = cs.TTA
    out_dir = os.path.join(ROOT, ".chip_smoke", "profile_tta")
    shutil.rmtree(out_dir, ignore_errors=True)
    fa.build_libraries()
    marks = {0: [], 1: [], 2: []}
    state = {"video": -1, "prof": None, "t0": 0.0, "wall": 0.0}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_phase(name):
        if name == "video":
            state["video"] += 1
            if state["video"] == 2:
                torch.cuda.synchronize()
                fa.reset_launches()
                prof.start()
                state["t0"] = time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[state["video"]].append((name, ev))
        if name == "video_end" and state["video"] == 2:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            prof.stop()

    argv = ["--method", "delta_a", "--preset", "longcat_13b", "--synthetic", "3",
            "--output-dir", out_dir, "--device", "cuda",
            "--height", str(T["height"]), "--width", str(T["width"]),
            "--num-cond-frames", str(T["cond_frames"]),
            "--tta-total-frames", str(T["tta_total_frames"]),
            "--num-frames", str(T["gen_frames"]), "--steps", str(T["tta_steps"]),
            "--es-check-every", str(T["check_every"]),
            "--es-patience", str(T["patience"]),
            "--num-inference-steps", str(T["inference_steps"]),
            "--guidance-scale", str(T["guidance"]), "--no-save-videos"]
    if args.depth != 48:
        raise SystemExit("--method delta_a profiles the full 48-block preset")
    summary = run_tta.main(argv, on_phase=on_phase)
    if summary["num_success"] != 3:
        raise SystemExit(f"{summary['num_success']}/3 videos succeeded")
    for i, r in enumerate(summary["results"]):
        print(f"[video {i}] train_time {r['train_time']:.3f} s, es_check_time "
              f"{r['es_check_time']:.3f} s, gen_time {r['gen_time']:.3f} s, "
              f"encode_time {r['encode_time']:.3f} s, total {r['total_time']:.3f} s")
    print("[video 1] phases:")
    phases = print_phases(marks[1])
    chunk_ms = sum(phases["train_chunk"])
    anchor_ms = phases["setup_anchor"] + phases["anchor_check"]
    print(f"[tta] train step {chunk_ms / T['tta_steps']:.1f} ms (mean of {T['tta_steps']}); "
          f"anchor eval {sum(anchor_ms) / len(anchor_ms):.1f} ms (mean of "
          f"{len(anchor_ms)}); per-video TTA {chunk_ms + sum(anchor_ms):.1f} ms")
    print(f"[profiled video] {state['wall']:.3f} s wall; launches fwd {fa.launches} "
          f"dq {fa.bwd_dq_launches} dkv {fa.bwd_dkv_launches}")
    device_breakdown(prof, state["wall"])
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


def lever_kwargs(args, runner_flags):
    """generate_vc's decode-lever arguments from run_tta's own flags
    (``--bsa-keep-ratio``, ``--quantize-decode``, ``--fast-decode``,
    ``--pab-*``, ``--cfg-reuse-*``, ``--gen-segment-steps``,
    ``--bucket-gen``), parsed and defaulted by the runner's code."""
    from longcat_video_tta_tpu_torch.runners import run_tta

    ra = run_tta.build_arg_parser().parse_args(
        ["--output-dir", "-", "--num-frames", str(args.gen_frames),
         "--num-inference-steps", str(args.steps), *runner_flags])
    run_tta.apply_fast_decode_defaults(ra)
    run_tta.check_decode_levers(ra)
    return dict(run_tta.decode_levers(ra), gen_segment_steps=ra.gen_segment_steps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="none", choices=["none", "delta_a"])
    ap.add_argument("--depth", type=int, default=48)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cond-frames", type=int, default=5)
    ap.add_argument("--gen-frames", type=int, default=8)
    args, runner_flags = ap.parse_known_args()

    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.method == "delta_a":
        if runner_flags:
            raise SystemExit(f"--method delta_a takes no decode-lever flags: {runner_flags}")
        return profile_delta_a(args)
    from longcat_video_tta_tpu_torch.config import longcat_13b
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc

    cfg = longcat_13b()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, depth=args.depth))
    fa.build_libraries()
    bundle, t_init = _sync_time(lambda: ModelBundle.init_random(cfg, seed=0))
    print(f"[init] {t_init:.2f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    H, W = 480, 832
    rng = np.random.default_rng(0)
    cond = rng.uniform(-1, 1, (1, 3, args.cond_frames, H, W)).astype(np.float32)
    prompt = "a ball moving across the scene"
    kw = dict(num_frames=args.gen_frames, num_inference_steps=args.steps,
              **lever_kwargs(args, runner_flags))
    print(f"[levers] {runner_flags} -> {kw}")
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
    print(f"[request] {t_req * 1e3:.1f} ms wall")
    print_phases(marks)

    # ---- profiled request -----------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    from longcat_video_tta_tpu_torch.ops import bsa

    fa.reset_launches()
    bsa.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_req = _sync_time(lambda: generate_vc(bundle, cond, prompt, **kw))
    print(f"[profiled request] {t_req:.3f} s wall, launches flash_fwd {fa.launches} "
          f"bsa_fwd {bsa.bsa_launches} bsa_fwd_qk_int8 {bsa.bsa_int8_launches} "
          f"bsa_block_sum {bsa.bsa_block_sum_launches}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_breakdown(prof, t_req)
    return 0


if __name__ == "__main__":
    sys.exit(main())
