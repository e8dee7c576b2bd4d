"""Sweep runner of the PyTorch port (counterpart of
``longcat_video_tta_tpu/sweep/run_sweep.py``): a YAML config -> runs of
the port's runner, in-process or as ``python -m`` subprocesses.

The YAML schema is the reference's: {method, series, series_name,
description, fixed: {...}, sweep: [{run_id, overrides...}]}, with its
key table, aliases and boolean flags. Also: --dry-run, --run-ids, a
wall-time estimate per row, resume (a row with a summary.json is
skipped), a preflight of every pending row before the first one runs,
--max-retries (rows resume from checkpoint.json), --jobs N concurrent
subprocess rows with a --device-pool pinned through
CUDA_VISIBLE_DEVICES, the fleet STOP file and the merged
``sweep_<series>.json`` launch record. ``--device`` is forwarded to
every row.

Every key of the reference's table reaches the port's runner under the
same flag (``compile_cache_dir`` names the kernels' build folder there,
``attn_impl`` the attention implementation). A row whose mesh keys
(``data_mesh``, ``context_mesh``, ``tensor_mesh``) ask for N > 1 ranks
runs as N processes through ``torchrun`` (``python -m
torch.distributed.run --standalone --nproc-per-node N``), and under
--jobs takes N entries of the device pool.

CLI:
  python -m longcat_video_tta_tpu_torch.sweep.run_sweep configs/smoke_tiny.yaml \
      --output-base /tmp/sweep --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

RUNNER_MODULE = "longcat_video_tta_tpu_torch.runners.run_tta"

# config key -> runner flag (the reference sweep's table)
_KEY_TO_FLAG = {
    "lr": "--lr",
    "steps": "--steps",
    "optimizer": "--optimizer",
    "num_cond_frames": "--num-cond-frames",
    "num_frames": "--num-frames",
    "gen_start_frame": "--gen-start-frame",
    "tta_total_frames": "--tta-total-frames",
    "tta_context_frames": "--tta-context-frames",
    "num_inference_steps": "--num-inference-steps",
    "guidance_scale": "--guidance-scale",
    "max_videos": "--max-videos",
    "seed": "--seed",
    "height": "--height",
    "width": "--width",
    "preset": "--preset",
    "checkpoint_dir": "--checkpoint-dir",
    "synthetic": "--synthetic",
    "lora_rank": "--lora-rank",
    "lora_alpha": "--lora-alpha",
    "lora_target_modules": "--lora-target-modules",
    "num_groups": "--num-groups",
    "delta_target": "--delta-target",
    "delta_dim": "--delta-dim",
    "target_blocks": "--target-blocks",
    "norm_target": "--norm-target",
    "film_mode": "--film-mode",
    "es_check_every": "--es-check-every",
    "es_patience": "--es-patience",
    "es_anchor_sigmas": "--es-anchor-sigmas",
    "es_noise_draws": "--es-noise-draws",
    "es_strategy": "--es-strategy",
    "es_holdout_fraction": "--es-holdout-fraction",
    "caption_guard_mode": "--caption-guard-mode",
    "fixed_caption": "--fixed-caption",
    "feature_frame_guard_mode": "--feature-frame-guard-mode",
    "clip_gate_threshold": "--clip-gate-threshold",
    "clip_gate_backend": "--clip-gate-backend",
    "clip_gate_sample_frames": "--clip-gate-sample-frames",
    "clip_gate_late_fraction": "--clip-gate-late-fraction",
    "clip_gate_aggregate": "--clip-gate-aggregate",
    "batch_videos": "--batch-videos",
    "retrieval_pool_dir": "--retrieval-pool-dir",
    "attn_impl": "--attn-impl",
    "warmup_steps": "--warmup-steps",
    "weight_decay": "--weight-decay",
    "max_grad_norm": "--max-grad-norm",
    "batch_method": "--batch-method",
    # decode-lever flags (round 2)
    "bsa_keep_ratio": "--bsa-keep-ratio",
    "quantize_decode": "--quantize-decode",
    "remat_policy": "--remat-policy",
    "compile_cache_dir": "--compile-cache-dir",
    "cfg_reuse_every": "--cfg-reuse-every",
    "cfg_reuse_start_frac": "--cfg-reuse-start-frac",
    "cfg_reuse_end_frac": "--cfg-reuse-end-frac",
    "loss_fetch_every": "--loss-fetch-every",
    # round-3 levers
    "video_parallel": "--video-parallel",
    "data_mesh": "--data-mesh",
    "context_mesh": "--context-mesh",
    "tensor_mesh": "--tensor-mesh",
    "lpips_model_path": "--lpips-model-path",
    "clip_gate_scorer": "--clip-gate-scorer",
    "clip_gate_sampling_mode": "--clip-gate-sampling-mode",
    "clip_gate_model_path": "--clip-gate-model-path",
    "aug_rotate_degrees": "--aug-rotate-degrees",
    "aug_speed_factors": "--aug-speed-factors",
    "gen_segment_steps": "--gen-segment-steps",
    "pab_every": "--pab-every",
    "pab_start_frac": "--pab-start-frac",
    "pab_end_frac": "--pab-end-frac",
    "load_fps": "--load-fps",
    "fast_decode_verify": "--fast-decode-verify",
    "dno_sampler_steps": "--dno-sampler-steps",
    "dno_interp_p": "--dno-interp-p",
    "dno_interp_every": "--dno-interp-every",
    "retrieval_sbert_path": "--retrieval-sbert-path",
    "i3d_model_path": "--i3d-model-path",
    "inception_model_path": "--inception-model-path",
    "vbench_towers_dir": "--vbench-towers-dir",
    "min_fvd_videos": "--min-fvd-videos",
    "caption_guard_topk": "--caption-guard-topk",
    "caption_guard_min_nonempty_ratio":
        "--caption-guard-min-nonempty-ratio",
    "caption_guard_min_unique_ratio": "--caption-guard-min-unique-ratio",
    "caption_guard_max_top1_ratio": "--caption-guard-max-top1-ratio",
    "caption_guard_max_generic_top1_ratio":
        "--caption-guard-max-generic-top1-ratio",
}

# Reference YAML key names accepted verbatim (run_sweep.py:51-136) so a
# FifthEpoch/longcat-video-tta sweep config drops in unchanged; each
# maps onto the runner's flag names.
_REF_ALIASES = {
    "learning_rate": "lr", "num_steps": "steps",
    "delta_lr": "lr", "delta_steps": "steps",
    "film_lr": "lr", "film_steps": "steps",
    "norm_lr": "lr", "norm_steps": "steps",
    "target_modules": "lora_target_modules",
    "lora_target_blocks": "target_blocks",
    "delta_target_blocks": "target_blocks",
    "target_ffn": "lora_target_ffn",
    "clip_gate_aggregation": "clip_gate_aggregate",
    "clip_gate_model": "clip_gate_model_path",
    "compute_fvd": "fvd_enabled",
}
# booleans: flag set iff true (the reference's convention)
_BOOL_FLAGS = {
    "es_disable": "--es-disable",
    "aug_enabled": "--aug-enabled",
    "aug_hflip": "--aug-hflip",
    "clip_gate_enabled": "--clip-gate-enabled",
    "clip_gate_log_only": "--clip-gate-log-only",
    "clip_gate_hash_tokenizer": "--clip-gate-hash-tokenizer",
    "skip_generation": "--skip-generation",
    "no_save_videos": "--no-save-videos",
    "no_kv_cache": "--no-kv-cache",
    "lora_target_ffn": "--lora-target-ffn",
    "fvd_enabled": "--fvd-enabled",
    "also_tune_delta": "--also-tune-delta",
    "use_builtin_lora": "--use-builtin-lora",
    "bucket_gen": "--bucket-gen",
    "native_prefetch": "--native-prefetch",
    "debug_nans": "--debug-nans",
    "clip_gate_fail_closed": "--clip-gate-fail-closed",
    "bucket_shapes": "--bucket-shapes",
    "save_adapters": "--save-adapters",
    "compute_vbench": "--compute-vbench",
    "fast_decode": "--fast-decode",
}

_MESH_KEYS = ("data_mesh", "context_mesh", "tensor_mesh")


def row_ranks(params: Dict[str, Any]) -> int:
    """The ranks a row's mesh needs: data x context x tensor (0 and 1
    both mean no mesh)."""
    n = 1
    for key in _MESH_KEYS:
        n *= max(1, int(params.get(key) or 0))
    return n


def load_config(path: str) -> Dict[str, Any]:
    """Validate {method, series, fixed, sweep}."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    for key in ("method", "series", "sweep"):
        if key not in cfg:
            raise ValueError(f"sweep config missing required key '{key}'")
    if not isinstance(cfg["sweep"], list) or not cfg["sweep"]:
        raise ValueError("sweep must be a non-empty list of rows")
    for row in cfg["sweep"]:
        if "run_id" not in row:
            raise ValueError(f"sweep row missing run_id: {row}")
    cfg.setdefault("fixed", {})
    return cfg


def build_argv(method: str, params: Dict[str, Any], output_dir: str,
               data_dir: Optional[str]) -> List[str]:
    """The runner's argv of one row (the reference's mapping)."""
    argv = ["--method", method, "--output-dir", output_dir]
    if data_dir:
        argv += ["--data-dir", data_dir]
    for key, val in params.items():
        key = _REF_ALIASES.get(key, key)
        if key == "resolution":
            # reference: "480p" (832x480 bucket)
            if str(val) not in ("480p", "480"):
                raise ValueError(f"unsupported resolution '{val}' (use height/width)")
            argv += ["--height", "480", "--width", "832"]
        elif key == "clip_gate_late_only":
            if val:
                argv += ["--clip-gate-sampling-mode", "late_only"]
        elif key == "clip_gate_fail_open":
            # the runner defaults to fail-open; the inverse flag closes it
            if not val:
                argv.append("--clip-gate-fail-closed")
        elif key == "delta_mode":
            # the reference's delta_c has a single mode; ours is per-channel
            if str(val) != "per_channel":
                raise ValueError(f"unknown delta_mode '{val}'")
        elif key == "compute_fid":
            print("[sweep] note: 'compute_fid' is driven by inception_model_path here; "
                  "key accepted for reference-YAML compat")
        elif key in _BOOL_FLAGS:
            if val:
                argv.append(_BOOL_FLAGS[key])
        elif key in _KEY_TO_FLAG:
            if val is not None:
                argv += [_KEY_TO_FLAG[key], str(val)]
        elif key in ("data_dir", "run_id"):
            pass
        else:
            raise ValueError(f"unknown sweep config key '{key}'")
    return argv


# Per-video costs on one NVIDIA H100 80GB HBM3 at 700 W, LongCat-13.6B at
# 480x832 (PERF.md §5: the per-method table on the 29-frame TTA window;
# the serving step at 5 cond and 8 generated frames): seconds per train
# step. full: longcat_bench_3b's step (at 13.6B its AdamW state
# does not fit the card); dno: per differentiated sampler step.
H100_TRAIN_STEP_S = {"delta_a": 2.77, "delta_b": 2.72, "delta_c": 0.74, "film": 2.81,
                     "lora": 3.37, "norm_tune": 2.91, "full": 1.00, "dno": 2.78}
H100_ANCHOR_FORWARD_S = 0.50   # anchor eval 3.00 s over 3 sigmas x 2 draws
H100_GEN_STEP_S = 0.65         # one CFG decode step of the serving request
# peak device memory per method on that card (GiB, PERF.md §5; lora
# with its W8A8 decode copy; none and the delta family share delta_a's)
H100_PEAK_GIB = {"delta_a": 55.9, "delta_b": 55.9, "delta_c": 55.9, "film": 55.9,
                 "norm_tune": 55.9, "none": 55.9, "lora": 68.2, "dno": 61.1,
                 "full": 52.4}


def estimate_minutes(method: str, params: Dict[str, Any]) -> float:
    """Wall-time heuristic per row: the reference's per-method model
    (train steps x step cost x window factor, the anchor evals, the CLIP
    gate, the denoising steps) on the H100 costs above.

    The window factor max(1, tta_total / 32) scales the step cost past the
    window the costs were measured on. The decode levers (BSA, W8A8)
    carry a factor of 1.0: PERF.md has no H100 ratio of a lever request
    to a dense one at the same geometry. The gate adds 0.1 s (its tower
    calls take 3.6-42 ms each on the card, PERF.md §6)."""
    n = int(params.get("max_videos", 100))
    steps = int(params.get("steps", 20))
    infer = int(params.get("num_inference_steps", 50))
    cond = int(params.get("num_cond_frames", 14))
    tta_total = int(params.get("tta_total_frames") or cond)
    wf = max(1.0, tta_total / 32.0)
    per_step_s = H100_TRAIN_STEP_S.get(method, H100_TRAIN_STEP_S["delta_a"]) * wf
    if method == "dno":
        per_step_s *= int(params.get("dno_sampler_steps", 4))
    train_s = 0.0 if method == "none" else steps * per_step_s

    es_s = 0.0
    # dno has no adapter snapshots: the runner disables early stopping
    if method not in ("dno", "none") and not params.get("es_disable", False):
        check_every = int(params.get("es_check_every", 5))
        sig = str(params.get("es_anchor_sigmas", "0.25,0.5,0.75"))
        draws = int(params.get("es_noise_draws", 2))
        n_anchor_fwd = len(sig.split(",")) * draws
        es_s = (steps / max(1, check_every)) * n_anchor_fwd * H100_ANCHOR_FORWARD_S * wf

    gate_s = 0.1 if params.get("clip_gate_enabled", False) else 0.0
    gen_s = infer * H100_GEN_STEP_S
    return n * (train_s + es_s + gate_s + gen_s) / 60.0


def estimate_memory_gb(method: str, params: Dict[str, Any]) -> Dict[str, float]:
    """Device and host memory per row: the method's measured peak on the
    H100 above (GiB), and the reference's host estimate (the frozen base
    stays on the device, so the host holds little)."""
    device = H100_PEAK_GIB.get(method, H100_PEAK_GIB["delta_a"])
    host = 8.0 if method != "full" else 16.0
    return {"device_hbm_gb": device, "host_gb": host}


def _release_device_memory() -> None:
    """Collect a finished in-process row's model (a bundle in a reference
    cycle would hold 30-55 GiB into the next row) and empty the CUDA
    caching allocator."""
    import gc

    gc.collect()
    try:
        import torch
    except ImportError:
        return
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def launch_command(argv: List[str], ranks: int = 1) -> List[str]:
    """The command of one row: the runner module, through torchrun with
    ``ranks`` processes when its mesh has more than one rank."""
    import sys

    if ranks > 1:
        return [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks), "-m", RUNNER_MODULE, *argv]
    return [sys.executable, "-m", RUNNER_MODULE, *argv]


def _execute_row(info: Dict[str, Any], argv: List[str],
                 subprocess_mode: bool, max_retries: int,
                 extra_env: Optional[Dict[str, str]] = None, ranks: int = 1) -> None:
    """Run one sweep row (with requeue-on-failure), mutating ``info``. A
    row of several ranks always runs as torchrun's processes."""
    t0 = time.time()
    for attempt in range(max_retries + 1):
        if subprocess_mode or extra_env or ranks > 1:
            import subprocess

            env = {**os.environ, **extra_env} if extra_env else None
            r = subprocess.run(launch_command(argv, ranks), env=env)
            info["returncode"] = r.returncode
            # the runner writes an explicit DRAINED sentinel on a
            # stop-file drain (checkpoint left for resume) — other
            # exit-0-without-summary paths (e.g. --preflight-only)
            # must not be misread as drained
            if r.returncode == 0 and os.path.exists(
                    os.path.join(info["output_dir"], "DRAINED")):
                info["status"] = "drained"
            else:
                info["status"] = "ok" if r.returncode == 0 else "failed"
        else:
            from ..runners.run_tta import main as run_main

            try:
                out = run_main(argv)
                info["status"] = ("drained" if isinstance(out, dict)
                                  and out.get("drained") else "ok")
            except Exception as e:
                import traceback

                info["status"] = f"failed: {type(e).__name__}: {e}"
                # fail loud in the sweep log: a swallowed start-up error
                # (bad frame window, missing path) otherwise reads as a
                # silently skipped row
                print(f"[sweep] {info['run_id']} FAILED: "
                      f"{type(e).__name__}: {e}")
                traceback.print_exc()
            _release_device_memory()
        if info["status"] in ("ok", "drained"):
            break
        if attempt < max_retries:
            print(f"[sweep] {info['run_id']} failed; requeue "
                  f"{attempt + 1}/{max_retries} (resumes from "
                  f"checkpoint.json)")
            info["retries"] = attempt + 1
    info["wall_minutes"] = round((time.time() - t0) / 60.0, 2)


def run_sweep(config_path: str, output_base: str,
              data_dir: Optional[str] = None,
              run_ids: Optional[List[str]] = None,
              dry_run: bool = False,
              subprocess_mode: bool = False,
              max_retries: int = 0,
              jobs: int = 1,
              device_pool: Optional[List[str]] = None,
              device: Optional[str] = None,
              ) -> List[Dict[str, Any]]:
    """``max_retries``: re-dispatch failed rows up to N times; each retry
    resumes from the row's checkpoint.json through the runner's per-video
    resume.

    ``jobs`` > 1: run up to N rows concurrently, each in its own
    subprocess. ``device_pool`` pins each concurrent slot to its own card
    through CUDA_VISIBLE_DEVICES (e.g. ["0", "1", "2", "3"] on a 4-GPU
    host); without it the processes share the visible cards. ``device``:
    the runner's --device for every row (None: its default, cuda)."""
    cfg = load_config(config_path)
    method = cfg["method"]
    series = cfg.get("series_name") or cfg["series"]
    rows = cfg["sweep"]
    if run_ids:
        rows = [r for r in rows if str(r["run_id"]) in set(run_ids)]

    launched = []
    pending = []   # (info, argv) rows that actually execute
    ranks: Dict[str, int] = {}  # run_id -> the ranks of its mesh
    for row in rows:
        run_id = str(row["run_id"])
        params = dict(cfg["fixed"])
        params.update({k: v for k, v in row.items() if k != "run_id"})
        out_dir = os.path.join(output_base, series, run_id)
        argv = build_argv(method, params, out_dir,
                          params.get("data_dir", data_dir))
        # fleet-level graceful drain: launched rows also see the sweep's
        # stop file (not just their own <out_dir>/STOP), so a STOP dropped
        # in the results root checkpoints running rows at their next
        # video boundary rather than only skipping pending ones
        argv += ["--stop-file", os.path.join(output_base, "STOP")]
        if device:
            argv += ["--device", device]
        est = estimate_minutes(method, params)
        info = {"run_id": run_id, "series": series, "method": method,
                "output_dir": out_dir, "argv": argv,
                "estimated_minutes": round(est, 1)}
        ranks[run_id] = row_ranks(params)
        launched.append(info)
        if os.path.exists(os.path.join(out_dir, "summary.json")):
            info["status"] = "skipped (summary.json exists)"
            print(f"[sweep] {run_id}: already complete, skipping")
            continue
        if dry_run:
            info["status"] = "dry-run"
            print(f"[sweep] DRY {run_id} (~{est:.0f} min): "
                  f"run_tta {' '.join(argv)}")
            continue
        info["estimated_memory"] = estimate_memory_gb(method, params)
        pending.append((info, argv))

    # Start-up preflight of every pending row before the first slot is
    # spent: --preflight-only runs the runner's fail-loud gates (frame
    # window / ES budget, data dir, caption guard, decode-lever combos)
    # without loading a model, so a row that would die at start-up is
    # reported and dropped in seconds. Synthetic rows are exempt
    # (preflight would regenerate the data).
    if pending and not dry_run and not subprocess_mode:
        from ..runners.run_tta import main as run_main

        healthy = []
        for info, argv in pending:
            if "--synthetic" in argv:
                healthy.append((info, argv))
                continue
            try:
                run_main(argv + ["--preflight-only"])
            except (Exception, SystemExit) as e:
                info["status"] = (f"preflight-failed: "
                                  f"{type(e).__name__}: {e}")
                print(f"[sweep] {info['run_id']} PREFLIGHT FAILED: {e}")
                continue
            healthy.append((info, argv))
        pending = healthy

    def _fleet_stop_file() -> Optional[str]:
        for c in (os.environ.get("LONGCAT_STOP_FILE"),
                  os.path.join(output_base, "STOP")):
            if c and os.path.exists(c):
                return c
        return None

    if jobs <= 1:
        for info, argv in pending:
            sf = _fleet_stop_file()
            if sf:
                info["status"] = "drained (not launched)"
                print(f"[sweep] {info['run_id']}: stop file {sf} "
                      f"present, not launching")
                continue
            print(f"[sweep] RUN {info['run_id']} "
                  f"(~{info['estimated_minutes']:.0f} min)")
            _execute_row(info, argv, subprocess_mode, max_retries,
                         ranks=ranks[info["run_id"]])
    elif pending:
        # concurrent rows, each its own subprocess; a card from the pool
        # travels with the worker slot, not the row; a row of N ranks
        # takes N slots (one lock: a row collects its slots whole)
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        n_slots = max(jobs, len(device_pool or ()))
        devq: "queue.Queue[Optional[str]]" = queue.Queue()
        for i in range(n_slots):
            devq.put(device_pool[i % len(device_pool)]
                     if device_pool else None)
        too_big = [i["run_id"] for i, _ in pending if ranks[i["run_id"]] > n_slots]
        if too_big:
            raise ValueError(f"rows {too_big} need more ranks than the {n_slots} device "
                             "slots of --jobs / --device-pool")
        take = threading.Lock()

        def worker(item):
            info, argv = item
            sf = _fleet_stop_file()
            if sf:
                info["status"] = "drained (not launched)"
                print(f"[sweep] {info['run_id']}: stop file {sf} "
                      f"present, not launching")
                return
            with take:
                devs = [devq.get() for _ in range(ranks[info["run_id"]])]
            try:
                dev = ",".join(d for d in devs if d) or None
                env = {"CUDA_VISIBLE_DEVICES": dev} if dev else {}
                info["device"] = dev
                print(f"[sweep] RUN {info['run_id']} "
                      f"(~{info['estimated_minutes']:.0f} min"
                      f"{', card ' + dev if dev else ''})")
                _execute_row(info, argv, True, max_retries,
                             extra_env=env or None, ranks=ranks[info["run_id"]])
            finally:
                for d in devs:
                    devq.put(d)

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            list(ex.map(worker, pending))

    os.makedirs(output_base, exist_ok=True)
    # merge by run_id rather than overwrite: several run_sweep calls over
    # the same series must not clobber each other's launch records
    state_path = os.path.join(output_base, f"sweep_{series}.json")
    merged: Dict[str, Any] = {}
    if os.path.exists(state_path):
        try:
            with open(state_path) as f:
                merged = {r["run_id"]: r for r in json.load(f)}
        except (json.JSONDecodeError, KeyError, TypeError):
            merged = {}
    for r in launched:
        merged[r["run_id"]] = r
    with open(state_path, "w") as f:
        json.dump(list(merged.values()), f, indent=2)
    return launched


def main(argv=None):
    p = argparse.ArgumentParser(description="YAML sweep runner (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--output-base", default="results")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--run-ids", default=None,
                   help="comma-separated run_id filter")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--subprocess", action="store_true",
                   help="isolate each row in its own process")
    p.add_argument("--max-retries", type=int, default=0,
                   help="requeue failed rows up to N times (rows resume from "
                        "checkpoint.json)")
    p.add_argument("--jobs", type=int, default=1,
                   help="run up to N rows concurrently, each in its own subprocess")
    p.add_argument("--device-pool", default=None,
                   help="comma-separated card ids to pin concurrent rows to through "
                        "CUDA_VISIBLE_DEVICES, e.g. '0,1,2,3' on a 4-GPU host")
    p.add_argument("--device", default=None,
                   help="the runner's --device for every row (default: the runner's, "
                        "cuda)")
    args = p.parse_args(argv)
    run_ids = args.run_ids.split(",") if args.run_ids else None
    pool = args.device_pool.split(",") if args.device_pool else None
    return run_sweep(args.config, args.output_base, args.data_dir, run_ids,
                     args.dry_run, args.subprocess,
                     max_retries=args.max_retries, jobs=args.jobs,
                     device_pool=pool, device=args.device)


if __name__ == "__main__":
    main()
