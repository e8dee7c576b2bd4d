#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases (each one fails the run when it fails):
  1. build: compile csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/bsa.cu and
     csrc/qk_norm_rope.cu with nvcc
     (sm_90a, one nvcc per source, started together) into
     longcat_video_tta_tpu_torch/csrc/build/ and print the build times and
     ptxas resource lines (registers, spills, and any wgmma or
     setmaxnreg notes); a kernel that spills fails the run;
  2. kernel check: the flash-attention kernel against its plain PyTorch
     version (``attention_reference``) in bf16 at the main path's shapes
     (decode self-attention, cross-attention, the no-cache prefix-masked
     self-attention), the decode self-attention of the runner's default
     geometry, the delta_a train step's and anchor eval's self-attention,
     plus small ragged / fp16 / head_dim 32 and 64 cases and the edges of
     the 128-key tiles (a prefix or kv_valid inside a tile, Sk not a
     multiple of 128, no visible key), with the error against a stated
     tolerance; times of the kernel, the plain version and torch's
     scaled_dot_product_attention (yardstick only; the port never calls
     it) beside the least time the card could take (the bound) and the
     share of it the kernel reaches;
  3. backward kernel check: the dQ and dK/dV kernels against
     ``attention_backward_reference`` on the card at the training shapes
     (the delta_a train step's self-attention, 10 920 tokens with a
     6240-token prefix, and its cross-attention dQ against 512 text
     tokens; the other methods' cross-attention dK/dV against those
     tokens, the train step at longcat_bench_3b's 20 heads and DNO's
     sampler step) plus small ragged / fp16 / no-visible-key cases and the
     edges of the kernels' tiles (a prefix inside a query and a key tile,
     all-conditioning and all-noise CTAs, kv_valid inside a tile, fused
     k/v views), with the per-output gates below; times of each kernel,
     the plain version and torch's scaled_dot_product_attention backward
     (yardstick only) beside each kernel's bound;
  3b. BSA kernel check: the gathered-attention kernel (16-bit and
     int8-QK) against ``bsa_reference`` on the same selection at the lever
     runs' decode shapes (top_k 8 and 10 at the default geometry, 6 at the
     --fast-decode one), every block selected against the forward kernel,
     small ragged / kv_valid / fp16 / head_dim 32 and 64 / 32- and
     512-token-block / 32- and 64-row q-block / -1 idx entry cases; the
     block-sum kernel against ``block_sum_reference``; times beside the
     plain version, dense SDPA, compiled flex_attention with a BlockMask
     (yardsticks only) and the bound over the pairs the selection lets
     through (int8-QK: also the kernel alone, without the quantize
     passes its wrapper runs);
  3c. q/k prologue check (``--only qknorm``): the fused per-head RMSNorm +
     RoPE kernels of csrc/qk_norm_rope.cu, forward and backward, against
     their plain versions (``norm_rope_reference``,
     ``norm_rope_backward_reference``) and a float64 evaluation (no more
     error than the rms_norm + apply_rope chain they replace) at
     generation's self- and cross-attention shapes (B 2, 8 latents), the
     delta_a train step's (B 1, 7 latents; cross-attention's k frozen;
     once with dw), and small cases (rows not a multiple of a CTA's, head
     dims 32 and 64, lane weights with dw, fp16); times of each kernel
     beside the bound (bytes) and the chain;
  4. small-input agreement: ``generate_vc`` on the card against the same
     weights and noise on the CPU (plain path), dense and with every
     decode lever (BSA with 32-token blocks, int8qk, PAB, CFG reuse), and one delta_a train
     step's loss and delta gradient on the card against the CPU, same
     weights and injected sigma and noise, longcat_demo widths; the same
     for one train step of each other method (and one DNO step), and LoRA
     merged into the weights against its side branch on the card;
  5. main path, serving: the port's ``run_baseline`` (the runner's
     ``--method none`` plus per_video_metrics.csv) answers 2
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
     PSNR/SSIM and run A's fast-vs-dense PSNR must be finite;
  8. main paths, the other methods: the runner on 1 video per method
     (lora on all eight sites under W8A8 decode, delta_b hidden, delta_c,
     film, norm_tune all_norm with a delta, full, dno) at the delta_a
     path's widths and window and 24 of its 48 blocks (to keep the
     script inside its time limit; full on longcat_bench_3b,
     whose full-weight TTA state fits the card), 3 steps (dno: 2 through a
     2-step sampler), 2 denoising steps. Each must succeed with finite
     losses, anchors and PSNR/SSIM, train (its anchor or DNO loss moves),
     report the trainable-parameter count of its configuration, and
     launch each kernel as often as ``method_launches`` derives;
  9. checkpoint path: a LongCat-13.6B-layout checkpoint (dit/, vae/,
     text_encoder/ as bf16 safetensors shards of at most 5 GB, 12 of the 48
     blocks (CUT_DEPTH),
     UMT5-XXL, WAN VAE base 96; no tokenizer folder) drawn on the card
     from a seed, written under a temporary folder in .chip_smoke/ (removed
     at the end) and loaded through the runner's --checkpoint-dir: load
     seconds, GB/s and the host's peak RSS; at least 64 loaded tensors
     (every kind of key) equal to their drawn values after the transform;
     one serving request on the loaded weights with [main]'s launches and
     finite metrics; a longcat_demo-width checkpoint loaded on the card and
     on the CPU, generate_vc agreeing at >= 30 dB;
 10. remat path: delta_a on longcat_bench (hidden 2048, 16 blocks, 16
     heads of 128) at the delta_a window under full, dots and dots_attn,
     3 steps each: step time, peak memory, launches per step against
     ``train_step_launches`` (64 / 32 / 16, dots_attn 32 / 32 / 16), loss
     within 1e-3 relative and gradient cosine >= 0.9999 of full's on the
     same draws; the runner trains longcat_bench under its default policy
     (dots_attn); the bytes each policy keeps per block at 13.6B width (2
     blocks), extrapolated to 48;
 11. bucket path: a 13.6B delta_a train step with the 3-latent target
     padded to 4 (pad filled with 1e3) against the unpadded one on the
     same valid draws (the same gates), then the runner on 1 video with
     --bucket-shapes --aug-enabled --aug-hflip --aug-speed-factors 2
     --save-adapters: launches against ``method_launches``, finite losses,
     a moving anchor, and the saved adapter loaded back.
  The kernel phases also time B1-B3 at the remat path's 16 heads and at
     the bucket shape (12 480 tokens, kv_valid 10 920; SDPA takes the same
     boolean mask).
 12. eval: the CLIP gate and the evaluation towers. (a) The five tower
     checkpoints drawn on the card from a seed in their published layouts
     and written (CLIP ViT-B/32 and X-CLIP base/32 as Hugging Face folders
     without a tokenizer, LPIPS AlexNet, pytorch-i3d, torchvision
     InceptionV3 as state dicts); (b) each tower converted on the card and
     on the CPU from the same file, same inputs: CLIP image and text
     embeds (4 frames at 480x832), the X-CLIP score (8 frames), LPIPS (8
     pairs), I3D (one 16 x 224 x 224 clip), InceptionV3 (16 frames):
     cosine >= 0.99999 and relative L2 <= 1e-4 in fp32, with each tower's
     time per call on the card; (c) the runner at 13.6B width and depth:
     delta_a on 2 videos (3 steps, check every 3, 4 denoising steps) with
     a log-only CLIP gate, LPIPS and online FVD + FID (finite gate scores,
     LPIPS, FVD and FID; 2 videos in the moments and in fvd_state.npz;
     launches as ``method_launches``), then 1 video that the X-CLIP gate
     skips (threshold 2.0: skip_tta, train_time 0, no backward launch,
     one generation's forward launches).
 13. opensora (``--only opensora``): the Open-Sora v2 MMDiT (11.8B: hidden
     3072, 19 double + 38 single blocks of 24 heads of 128; T5-XXL-sized
     encoder, CLIP-L/14 text, WAN VAE). (a) B1 at its serving shape (3
     CFG rows of 8312 joint tokens, no prefix), its anchor eval's (1 x
     8312) and its train step's (1 x 11 432), B2 and B3 at the train
     step's, and a ragged case with v a strided view of a fused output,
     all under the gates above with plain and SDPA times; (b) a small
     MMDiT with head_dim 128 (hidden 256, the published axes_dims) on the
     card against the CPU: generate_vc >= 30 dB, one delta_a and one LoRA
     train step within the step agreement's gates; (c) the runner at
     full width and 10 + 19 of the 19 + 38 blocks (the script's time
     limit): --method none (2 requests at [main]'s
     geometry), a lever request (W8A8, PAB and CFG reuse every 2, 2-step
     segments, --fast-decode-verify 1), delta_a on the TTA window (6
     steps), lora (3 steps) and full at a depth cut of 4 double + 8
     single blocks (3 steps; at 11.8B its AdamW state would exceed the
     card): finite metrics and losses, a moving anchor, the trainable
     count, peak memory and launches equal to ``joint_run_launches``;
     (d) a checkpoint folder (dit/ and clip/ in Open-Sora v2's layout,
     vae/, and text_encoder/ in the UMT5 per-block layout the JAX
     converter reads, not T5 v1.1's; bf16 shards, full width at the depth
     cut) loaded through
     --checkpoint-dir, sampled tensors equal to their shard values after
     the RoPE row permutation, and one request on it.
 14. cogvideox (``--only cogvideox``): CogVideoX-5B-I2V (5.57B: hidden
     3072, 42 blocks of 48 heads of 64; T5-XXL-sized encoder, 226 tokens;
     WAN VAE at base 128). (a) B1 at its serving shape (2 CFG rows of 8026
     joint tokens, no mask), its anchor eval's (1 x 8026) and its train
     step's (1 x 11 146), B2 and B3 at the train step's, head_dim 64,
     under the gates above with plain and SDPA times; (b) a small
     CogVideoX with head_dim 64 (hidden 256, rope_dims (16, 24, 24)) on
     the card against the CPU: generate_vc >= 30 dB, one delta_a, LoRA
     and full train step within the step agreement's gates; (c) the
     runner at full width and 21 of the 42 blocks (the script's time
     limit): --method none (2 requests at [main]'s
     geometry), the lever request as in 13, delta_a on the TTA window (6
     steps), lora (3 steps) and full at a depth cut of 16 of 42 blocks (3
     steps; at 5.57B its AdamW state would not fit beside the encoder):
     finite metrics and losses, a moving anchor, the trainable count,
     peak memory and launches equal to ``joint_run_launches``.
 15. t2v (``--only t2v``): B1 at the text-to-video shapes (self-attention
     over 2 x 12 480 tokens with no mask, cross-attention against 512
     text tokens) against the plain version and SDPA, then ``run_t2v`` at
     LongCat-13.6B width and depth: 2 requests of 29 frames at 4 denoising
     steps (a --data-dir of 2 captions), then 1 with --pab-every 2
     --cfg-reuse-every 2; frames finite in [0, 1], gen_time per request,
     launches equal to ``t2v_launches``.
 16. vbench (``--only vbench``): (a) the VBench towers at their published
     geometry (DINO ViT-S/16, CLIP-L/14 with the LAION aesthetic head,
     MUSIQ-SPAQ) drawn on the card, written under .chip_smoke/ (removed at
     the end), each on the card against the CPU under [eval]'s gates with
     its time per call; (b) a configs/-style YAML row through
     ``sweep.run_sweep``: delta_a at 13.6B on 1 synthetic video (3 steps,
     check every 3, 4 denoising steps) with --save-adapters and
     --compute-vbench (online_eval.vbench: backend torch-native, five
     finite dimensions in [0, 1], no error), compile_cache_dir "auto"
     forwarded (the kernels' default build folder), launches as
     ``method_launches``; then
     ``run_eval_adapters --mode adapted --bsa-keep-ratio 0.5`` on the row
     (launches as ``sweep_eval_launches``), ``run_eval``'s best_configs
     and vbench modes and ``export_results``.

 17. vp (``--only vp``): --video-parallel. (a) B1 at the shapes the lanes
     fold into (the train step's self-attention over 10 920 tokens with a
     6240-token prefix and its cross-attention against 512 text tokens at
     B 2, the anchor eval's 7800 tokens at 12 rows), B2 and B3 at the
     train step's, against the plain version and SDPA; (b) one batched
     delta_a step of 2 lanes at longcat_demo width, card vs CPU (each
     lane's loss and gradient under the step agreement's gates); (c) the
     runner at LongCat-13.6B width and depth on the delta_a path's window:
     delta_a with --video-parallel 2 --native-prefetch on 2 videos (3
     steps, check every 3, 4 denoising steps, LPIPS, adapters saved), the
     same 2 videos one after the other, and lora on 8 sites at V 2: each
     lane's step-0 loss within 1e-3 of its sequential run's, later ones
     within 1e-2, the same best step, adapter cosine >= 0.99, finite
     metrics; launches per batched train step equal to one video's
     (``train_step_launches``) and in all ``vp_launches``; the batched
     step, the anchor eval and the TTA's own peak memory beside one
     video's.
 18. flags (``--only flags``): one longcat_demo video per flag: the default
     run, --profile-dir (a torch.profiler trace whose kernel events include
     flash_fwd), --debug-nans and --attn-impl xla (the default run's losses
     and anchors within 1e-2; xla launches no kernel), --compile-cache-dir
     on a fresh folder (the four libraries are built there).
 19. tools (``--only vp,tools``): eval_external on [vp]'s clips against
     their ground truth on the card with LPIPS and I3D tower files drawn
     on the card (to 1e-4 of the runner's metric code on the same clips,
     near the runner's recorded values, which were taken before the clip
     was saved as uint8; finite FVD), then compare_all, diagnostics status
     and audit, export_results, export_loss_curves and (where matplotlib is
     installed; the card's machine has none) figures over [vp]'s runs.
 20. mesh (``--only mesh``): the multi-rank paths, in rank processes that
     share this card over gloo (NCCL refuses two ranks on one GPU; gloo
     moves every message through host memory, so no time here measures a
     real mesh). The kernel libraries are built before any rank starts.
     (a) B1-B3 at the ring's chunk shapes with their global offsets in
     this process (10 920 tokens with a 6240-token prefix in chunks of
     5460 and 2730: cond x cond, straddling, all-noise chunks and cond
     rows against an all-noise chunk, the CTAs with no tile; the decode's
     cache and noise pieces; 16 heads, tensor parallelism's) against the
     plain version, timed beside SDPA with the same boolean mask and the
     bound of the pairs the mask lets through; then ``ring_self_attention``
     in 2 and 4 ranks (the train sequence, the serving decode with and
     without a key bound, the 12 480-token bucket) against one launch over
     the whole sequence and against the plain version under the gates of
     2 and 3, each rank's launches P forward (2P for the decode's two
     pieces), P dQ and P dK/dV; (b) the runner at LongCat-13.6B width
     (MESH["depth"], 6 of 48 blocks) on delta_a's window
     (3 steps, a check every 3, 4 denoising steps): --context-mesh 2 and
     --tensor-mesh 2 against one rank's run of 1 video, --video-parallel 2
     --data-mesh 2 against one rank's --video-parallel 2 run of 2 videos:
     step-0 loss within 1e-3, later losses and anchors within 1e-2, the
     same best step, adapter cosine >= 0.99, each clip within 30 dB of the
     one-rank clip, finite PSNR/SSIM, each rank's launches as
     ``mesh_launches``; per-rank step, anchor and peak memory beside one
     rank's; (c) in the 2-rank world, the small MMDiT and CogVideoX under
     tensor parallelism against one rank: forward relative L2 <= 1e-2,
     one delta_a step's loss within 1e-2 and gradient cosine >= 0.99.
     The ranks start twice: the 4-rank ring, then one 2-rank world for
     the 2-rank ring, (c) and the three runs of (b), one after another
     (the one-rank runs of (b) go first, in this process).
 21. demo (``--only demo``): the science loop at longcat_demo's full
     width (DiT 768, 8 blocks, 6 heads of 128; WAN VAE base 32) and
     192x320. (a) One VAE step and one DiT pretraining step (every DiT
     parameter) at pretraining's shapes (batch 2; 9-frame clips; 4 + 8
     latents) on the card against the CPU, same weights and draws, under
     the step agreement's gates (the CPU side runs in a background thread
     from before the main path on); (b) ``scripts.pretrain_demo`` cut to
     ``DEMO["vae_steps"]`` and ``DEMO["dit_steps"]`` (batch 2, 4 + 8
     latent windows): the last logged recon MSE and flow
     loss each at most half of step 0's, launches as
     ``pretrain_launches``; (c) the checkpoint it writes, loaded as
     ``run_tta --checkpoint-dir`` loads it, equal to the trained modules
     tensor for tensor; (d) ``scripts.run_demo_campaign`` on it, rows
     baseline and full, the NOTTA and FULL entries, on 2 distribution-B
     videos each with the synthetic towers and the YAMLs' 50 denoising
     steps: every row ok, every metric finite (PSNR, SSIM, LPIPS, FVD,
     FID, the five VBench dimensions), launches as ``demo_row_launches``.
 22. longhorizon (``--only longhorizon``): the 93-frame decode of
     ``scripts.measure_longhorizon`` at its geometry (longcat_bench at full
     width and all 16 blocks; 4 cond + 24 generated latents of 60 x 104:
     37 440 queries against 6240 cached + 37 440 fresh keys). (a) B1 at
     the dense decode (B 2, 16 heads) against the plain version and SDPA;
     the block sums over the queries and the keys; BSA 16-bit at top_k 8
     and 16 of 43 key blocks against compiled flex_attention, int8-QK at
     8; (b) the script's function in corr mode (the dense bf16 decode,
     then W8A8 + BSA keep 0.15) and in wall mode (W8A8, int8-QK BSA at
     keep 0.15, PAB every 4 and CFG reuse every 2 over [0.06, 0.96)), 10
     denoising steps (not 50) in segments of 5: finite latents of the
     93-frame shape, latent corr >= 0.999, peak memory, launches equal
     to ``longhorizon_launches``. It runs right after the agreements.
 23. bench (``--only bench``): ``scripts.bench``, the root bench.py's two
     hot loops, at its geometry (longcat_bench at full width and all 16
     blocks; latents of 60 x 104: a 4680-token train sequence behind a
     3120-token prefix; 4 cond + 8 generated latents, 12 480 queries
     against 6240 cached + 12 480 fresh keys). (a) B1 at its decode (B 2,
     16 heads) and B1-B3 at its train step's self-attention and
     cross-attention (512 text tokens), against the plain version and
     SDPA; the block sums over the decode's queries and keys; BSA 16-bit
     at keep 0.35's top_k against compiled flex_attention; (b) every
     section of the script with only its step counts cut (``BENCH``):
     delta_a and LoRA r1 at 1 + 2 steps, the five continuation forms at 4
     denoising steps from one pair of initial noises, the V 2 warm-up and
     timed chunks of 2 steps, scale 2 (longcat_bench_3b, 24 blocks) at
     1 + 1 steps and a 2-step continuation, the flagship block at depths 1
     and 2 at 1 + 1 steps: finite losses and latents of their shapes, the BSA and W8A8 +
     BSA forms' latent corr >= 0.999 against the dense form, every key of
     the root bench.py's line present and none null, the card's MFU
     peak, launches equal to ``bench_launches``. It runs right after
     [longhorizon].

The lever runs (7), the checkpoint path (9), [eval], [t2v], [vbench] and
[vp] run LongCat-13.6B at 12 of its 48 blocks (``CUT_DEPTH``, full
widths), the method runs 24, [mesh]'s runner runs 6, and the Open-Sora
and CogVideoX runner runs half their blocks, to keep the script inside
its time limit.

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
import re
import shutil
import subprocess
import sys
import time
import zlib

# the tower files' layouts and writers: the package's synthetic-tower
# script, one writer for both (the port's tests read the CLIP and
# InceptionV3 layouts through this module too)
from longcat_video_tta_tpu_torch.scripts.make_synth_towers import (  # noqa: E402
    CLIP_GEOMETRY,
    clip_hf_config,
    clip_state_shapes,
    i3d_state_shapes,
    inception_state_shapes,
    lpips_state_shapes,
    tower_value,
    write_tower_files,
    write_vbench_tower_files,
)

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


def _timed_once(fn):
    """(fn(), its milliseconds on the card's clock): one run, no warm-up
    (a plain version, whose result a gate also reads)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _allowed_pairs(Sq: int, Sk: int, ncond: int, kv_valid=None, q_offset: int = 0,
                   k_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through: the work this input needs.
    Queries sit at global indices q_offset.., keys at k_offset.. (a ring
    chunk); the prefix rule applies to square inputs, the key bound
    ``kv_valid`` to global key indices."""
    clamp = lambda x, hi: max(0, min(x, hi))
    kv = Sk + k_offset if kv_valid is None else kv_valid
    n_keys = clamp(kv - k_offset, Sk)
    pairs = Sq * n_keys
    if ncond > 0 and Sq == Sk:
        cond_rows = clamp(ncond - q_offset, Sq)
        cond_keys = clamp(min(ncond, kv) - k_offset, Sk)
        pairs -= cond_rows * (n_keys - cond_keys)
    return pairs


def _bound_ms(B, H, Sq, Sk, D, ncond, kv_valid, elem_bytes, q_offset=0, k_offset=0):
    flops = 4.0 * B * H * D * _allowed_pairs(Sq, Sk, ncond, kv_valid, q_offset, k_offset)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem_bytes + B * Sq * H * 4
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bwd_bound_ms(B, H, Sq, Sk, D, ncond, kv_valid, elem_bytes, dkv: bool, q_offset=0,
                  k_offset=0):
    """Least time of one backward kernel: 8*D FLOP per allowed pair for
    dK/dV (S, dP, dV, dK), 6*D for dQ (S, dP, dQ); bytes: q, k, v, dO and
    the fp32 lse and delta read once, dq (or dk and dv) written once."""
    flops = (8.0 if dkv else 6.0) * B * H * D * _allowed_pairs(Sq, Sk, ncond, kv_valid,
                                                              q_offset, k_offset)
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


def sdpa_mask(Sq: int, Sk: int, ncond: int, kv_valid, q_offset: int = 0, k_offset: int = 0):
    """The boolean allowed-mask SDPA takes for the kernels' masks (the
    conditioning prefix when Sq == Sk, keys past kv_valid; global indices
    from the offsets), or None."""
    import torch

    if not (ncond > 0 and Sq == Sk) and kv_valid is None:
        return None
    qi = torch.arange(Sq, device="cuda")[:, None] + q_offset
    ki = torch.arange(Sk, device="cuda")[None, :] + k_offset
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if ncond > 0 and Sq == Sk:
        mask = (qi >= ncond) | (ki < ncond)
    if kv_valid is not None:
        mask = mask & (ki < kv_valid)
    return mask


def case_inputs(B, H, Sq, Sk, D, *, dtype_name="bfloat16", fused_kv=False, fused_v_mlp=0,
                seed=0):
    """Seeded q, k, v on the card; with ``fused_kv`` k and v are strided
    views of one [B, Sk, 2, H, D] tensor (the cross-attention layout);
    with ``fused_v_mlp`` v is a view of a [B, Sk, 3 H D + fused_v_mlp]
    tensor (the MMDiT single block's linear1 output, token stride
    3 H D + mlp), q and k contiguous (rope's outputs)."""
    import torch

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    if fused_kv:  # k, v as strided views of a fused [B, Sk, 2, H, D] output
        kv = torch.randn((B, Sk, 2, H, D), generator=g, device="cuda").to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    elif fused_v_mlp:
        k = torch.randn((B, Sk, H, D), generator=g, device="cuda").to(dtype)
        h = torch.randn((B, Sk, 3 * H * D + fused_v_mlp), generator=g, device="cuda")
        v = h.to(dtype)[..., :3 * H * D].reshape(B, Sk, 3, H, D)[:, :, 2]
    else:
        k = torch.randn((B, Sk, H, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, Sk, H, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def reference(fa, q, k, v, ncond, kv_valid):
    """The plain version, chunked over heads to fit beside the inputs, and
    over query rows where one head's fp32 scores would pass 2 GB and no
    prefix rule ties the rows together (the 93-frame decode's 37 440 x
    43 680)."""
    import torch

    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    chunk = max(1, min(H, int(2e9 // (4 * B * Sq * Sk * 4)) or 1))
    rows = Sq if (ncond > 0 and Sq == Sk) else max(1, min(Sq, int(2e9 // (4 * B * Sk))))
    if rows >= Sq:
        return _reference_chunked(fa, q, k, v, ncond, kv_valid, chunk)
    parts = [_reference_chunked(fa, q[:, r0:r0 + rows], k, v, 0, kv_valid, chunk)
             for r0 in range(0, Sq, rows)]
    return tuple(torch.cat(x, dim=1) for x in zip(*parts))


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
                      dtype_name="bfloat16", fused_kv=False, fused_v_mlp=0, timed=False,
                      seed=0):
    """Kernel vs plain version on one shape; returns a result dict."""
    import torch
    import torch.nn.functional as F

    q, k, v = case_inputs(B, H, Sq, Sk, D, dtype_name=dtype_name, fused_kv=fused_kv,
                          fused_v_mlp=fused_v_mlp, seed=seed)
    o, lse = fa.flash_attention(q, k, v, num_cond_tokens=ncond, kv_valid_len=kv_valid)
    torch.cuda.synchronize()
    # the plain version is timed on the gate's own run (one cold run)
    (o_ref, lse_ref), plain_ms = _timed_once(lambda: reference(fa, q, k, v, ncond,
                                                               kv_valid))
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
        res["plain_ms"] = plain_ms
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = sdpa_mask(Sq, Sk, ncond, kv_valid)
        res["library_ms"] = _events_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=10)
        res["bound_ms"], res["bound_by"] = _bound_ms(
            B, H, Sq, Sk, D, ncond, kv_valid, q.element_size())
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
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
    recompute; DNO's sampler step has the same shape) and the anchor
    eval's (6 rows of 4 cond + 1 val latents, 7800 tokens; 96 launches
    per eval); and the train step at longcat_bench_3b's 20 heads."""
    from longcat_video_tta_tpu_torch.tta.bucket import bucket_len

    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    n_cond_lat, n_train_lat, n_val_lat = tta_split()
    ncond = n_cond_lat * tokens_per_frame
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    s_anchor = (n_cond_lat + n_val_lat) * tokens_per_frame
    s_bucket = (n_cond_lat + bucket_len(n_train_lat)) * tokens_per_frame
    return [("train_self", (1, H, s_train, s_train, D), dict(ncond=ncond, seed=8)),
            ("anchor_self", (6, H, s_anchor, s_anchor, D), dict(ncond=ncond, seed=9)),
            # full's train step on longcat_bench_3b (20 heads of 128)
            ("train_self_h20", (1, 20, s_train, s_train, D), dict(ncond=ncond, seed=12)),
            # the remat path's train step on longcat_bench (16 heads of 128)
            ("train_self_h16", (1, 16, s_train, s_train, D), dict(ncond=ncond, seed=13)),
            # the bucket path's: the 3-latent target padded to 4, the pad
            # masked as keys by kv_valid
            ("train_self_bucket", (1, H, s_bucket, s_bucket, D),
             dict(ncond=ncond, kv_valid=s_train, seed=14))]


def demo_kernel_cases():
    """(name, shape args, options) of the attention calls of one
    longcat_demo pretraining step ([demo] (b), scripts/pretrain_demo): a
    batch of 2 windows of 4 cond + 8 target latents at 192 x 320 (240
    tokens a latent frame: 2880 tokens, a 960-token prefix), 6 heads of
    128; the cross-attention against the text tokens (fused k/v). Every
    parameter trains, so both have a dQ and a dK/dV launch."""
    from longcat_video_tta_tpu_torch.config import longcat_demo

    cfg = longcat_demo()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tpf = (DEMO["height"] // sf) * (DEMO["width"] // sf)
    S, ncond = (DEMO["cond_lat"] + DEMO["target_lat"]) * tpf, DEMO["cond_lat"] * tpf
    B, H, D = DEMO["batch"], cfg.dit.num_heads, cfg.dit.head_dim
    return [("demo_pretrain_self", (B, H, S, S, D), dict(ncond=ncond, seed=15)),
            ("demo_pretrain_cross", (B, H, S, cfg.dit.text_len, D),
             dict(fused_kv=True, seed=16))]


def phase_kernel_checks(fa, dit_cfg, tokens_per_frame):
    cases = [check_kernel_case(fa, name, *shape, timed=True, **opts)
             for name, shape, opts in (main_path_cases(dit_cfg, tokens_per_frame)
                                       + tta_kernel_cases(dit_cfg, tokens_per_frame)
                                       + demo_kernel_cases())]
    cases += [
        check_kernel_case(fa, "ragged_kv_valid", 1, 3, 200, 333, 64,
                          kv_valid=250, seed=3),
        check_kernel_case(fa, "ragged_prefix_d32", 2, 2, 150, 150, 32, ncond=37,
                          seed=4),
        check_kernel_case(fa, "fp16_d128", 1, 2, 96, 130, 128,
                          dtype_name="float16", seed=5),
        check_kernel_case(fa, "no_visible_key", 1, 2, 64, 64, 64, kv_valid=0, seed=6),
        # the 128-key tiles: a prefix ending inside a key tile with
        # all-conditioning, mixed and noise query tiles; fused k/v views
        # with Sk not a multiple of 128
        check_kernel_case(fa, "prefix_in_key_tile_fp16_d64", 1, 2, 400, 400, 64,
                          ncond=200, dtype_name="float16", seed=10),
        check_kernel_case(fa, "fused_kv_sk300_d128", 2, 2, 130, 300, 128, fused_kv=True,
                          seed=11),
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
                   dtype_name="bfloat16", fused_kv=False, fused_v_mlp=0, timed=False,
                   seed=0, dkv=True, all_zero=False, zero_do_from=None):
    """The dQ (and, with ``dkv``, dK/dV) kernel against the plain backward
    on one shape, from the forward kernel's o and lse; returns a result
    dict per kernel. ``zero_do_from``: query rows from this index on get
    dO = 0 (the bucket pad, which the masked loss does not reach)."""
    import torch
    import torch.nn.functional as F

    q, k, v = case_inputs(B, H, Sq, Sk, D, dtype_name=dtype_name, fused_kv=fused_kv,
                          fused_v_mlp=fused_v_mlp, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    if zero_do_from is not None:
        do[:, zero_do_from:] = 0
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv_valid)
    o, lse = fa.flash_attention(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    got = {"flash_bwd_dq": (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),)}
    if dkv:
        got["flash_bwd_dkv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    # the plain version is timed on the gate's own run (one cold run)
    (ref_dq, ref_dk, ref_dv), plain_ms = _timed_once(
        lambda: backward_reference(fa, q, k, v, o, lse, do, ncond, kv_valid))
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
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        mask = sdpa_mask(Sq, Sk, ncond, kv_valid)
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
    from longcat_video_tta_tpu_torch.tta.bucket import bucket_len

    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    n_cond_lat, n_train_lat = tta_split()[:2]
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    ncond = n_cond_lat * tokens_per_frame
    cases = check_bwd_case(fa, "train_self", 1, H, s_train, s_train, D, ncond=ncond,
                           timed=True, seed=21)
    cases += check_bwd_case(fa, "train_cross_dq", 1, H, s_train, dit_cfg.text_len, D,
                            fused_kv=True, timed=True, seed=22, dkv=False)
    # the other methods' shapes: cross-attention dK/dV (LoRA on xattn_kv,
    # norm_tune's cross k_norm, full), the train step at longcat_bench_3b's
    # 20 heads, and DNO's sampler step over its window (the split keeps
    # one latent out at holdout 0 too, so it is the train step's shape)
    cases += check_bwd_case(fa, "train_cross_dkv", 1, H, s_train, dit_cfg.text_len, D,
                            fused_kv=True, timed=True, seed=32)
    cases += check_bwd_case(fa, "train_self_h20", 1, 20, s_train, s_train, D, ncond=ncond,
                            timed=True, seed=33)
    s_dno = sum(tta_split(holdout=0.0)[:2]) * tokens_per_frame
    cases += check_bwd_case(fa, "dno_self", 1, H, s_dno, s_dno, D, ncond=ncond,
                            timed=True, seed=34)
    # the remat path's train step on longcat_bench (16 heads), and the
    # bucket path's: 12 480 tokens of which the last 1560 are pad, masked
    # as keys (kv_valid 10 920) and given a zero dO by the masked loss
    cases += check_bwd_case(fa, "train_self_h16", 1, 16, s_train, s_train, D, ncond=ncond,
                            timed=True, seed=35)
    s_bucket = (n_cond_lat + bucket_len(n_train_lat)) * tokens_per_frame
    cases += check_bwd_case(fa, "train_self_bucket", 1, H, s_bucket, s_bucket, D,
                            ncond=ncond, kv_valid=s_train, timed=True, seed=36,
                            zero_do_from=s_train)
    # a longcat_demo pretraining step's self- and cross-attention ([demo] (b))
    for name, shape, opts in demo_kernel_cases():
        cases += check_bwd_case(fa, name, *shape, timed=True, **opts)
    cases += check_bwd_case(fa, "ragged_prefix_d32", 2, 2, 150, 150, 32, ncond=37,
                            seed=23)
    cases += check_bwd_case(fa, "ragged_kv_valid_d64", 1, 3, 200, 333, 64,
                            kv_valid=250, seed=24)
    cases += check_bwd_case(fa, "fp16_d128", 1, 2, 96, 130, 128,
                            dtype_name="float16", seed=25)
    cases += check_bwd_case(fa, "no_visible_key", 1, 2, 64, 64, 64, kv_valid=0,
                            seed=26, all_zero=True)
    # the tiles of the wgmma kernels (dK/dV: 128 keys x 64-query tiles; dQ:
    # 128 rows x 128-key tiles): a prefix inside a query and a key tile,
    # all-conditioning and all-noise CTAs, kv_valid inside a tile, fused
    # k/v views with Sk not a multiple of 128, ragged D 32 in fp16
    cases += check_bwd_case(fa, "ncond_straddles_tiles_d128", 2, 2, 300, 300, 128,
                            ncond=100, seed=27)
    cases += check_bwd_case(fa, "cond_and_noise_ctas_fp16_d64", 1, 2, 520, 520, 64,
                            ncond=260, dtype_name="float16", seed=28)
    cases += check_bwd_case(fa, "kv_valid_inside_tile_d128", 2, 2, 150, 400, 128,
                            kv_valid=333, seed=29)
    cases += check_bwd_case(fa, "fused_kv_sk300_d128", 2, 2, 130, 300, 128,
                            fused_kv=True, seed=30)
    cases += check_bwd_case(fa, "ragged_fp16_d32", 2, 2, 70, 190, 32,
                            dtype_name="float16", seed=31)
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
                   qk_int8=False, timed=False, seed=0, dense_check=False, hole=False):
    """BSA kernel vs its plain version on one shape and selection. With
    ``hole`` the kernel gets idx with entry 1 set to -1 (no block), the
    plain version idx without that entry."""
    import torch
    import torch.nn.functional as F

    q, k, v = case_inputs(B, H, Sq, Sk, D, dtype_name=dtype_name, seed=seed)
    idx = bsa.select_blocks(q, k, block_q=block_q, block_k=block_k, top_k=top_k,
                            num_cond_tokens=ncond, q_token_offset=Sk - Sq,
                            kv_valid=kv_valid)
    idx_ref = idx
    if hole:
        idx_ref = idx[:, :, [j for j in range(top_k) if j != 1]].contiguous()
        idx = idx.clone()
        idx[:, :, 1] = -1
    kw = dict(block_q=block_q, block_k=block_k, kv_valid=kv_valid, qk_int8=qk_int8)
    o = bsa.bsa_forward(q, k, v, idx, **kw)
    torch.cuda.synchronize()
    # the plain version is timed on the gate's own run (one cold run)
    o_ref, plain_ms = _timed_once(lambda: bsa.bsa_reference(q, k, v, idx_ref, **kw))
    e = bsa_errors(o, o_ref, dtype_name, qk_int8)
    ok = e.pop("ok")
    bound = Sk if kv_valid is None else min(Sk, kv_valid)
    res = {"kernel": "bsa_fwd_qk_int8" if qk_int8 else "bsa_fwd", "case": name,
           "B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D, "top_k": top_k,
           "block_q": block_q, "block_k": block_k, "ncond": ncond, "kv_valid": kv_valid,
           "dtype": dtype_name, **e}
    if qk_int8:  # fidelity of int8qk: against the 16-bit plain version
        o16 = bsa.bsa_reference(q, k, v, idx_ref, block_q=block_q, block_k=block_k,
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
        res["plain_ms"] = plain_ms
        res["pairs"] = bsa_pairs(idx, block_q, block_k, Sq, bound)
        res["bound_ms"], res["bound_by"] = bsa_bound_ms(
            B, H, Sq, Sk, D, res["pairs"], q.element_size(), qk_int8)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        if qk_int8:  # "ms" includes the quantize passes outside the kernel
            res["quantize_ms"] = _events_ms(lambda: bsa.quantize_qk(q, k), iters=5)
            args = bsa.quantize_qk(q, k)
            res["kernel_ms"] = _events_ms(lambda: bsa._launch_bsa(
                *args, v, idx, block_q, block_k, kv_valid, q.shape[-1] ** -0.5), iters=10)
            del args
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
        ("blocks_q64_ragged", dict(B=1, H=2, Sq=200, Sk=640, D=64, top_k=3, block_q=64,
                                   block_k=128, ncond=128)),
        ("negative_idx_entry", dict(B=1, H=2, Sq=256, Sk=1024, D=128, top_k=4,
                                    block_q=128, block_k=128, hole=True)),
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


# The q/k prologue (csrc/qk_norm_rope.cu) against its plain version (the
# same fp32 arithmetic in torch, rounded once at the end): the two round
# fp32 values that differ in their last bits (fused multiply-adds, the
# sum of squares in another order), so an output element differs by at
# most one ulp and few do:
#   max|y - y_ref| <= eps * max|y_ref|,  ||y - y_ref||_2 <= eps / 4 * ||y_ref||_2
# (dx: twice both, its mean term summed in another order too); the fp32
# dw to 1e-4 relative. Against a float64 evaluation of the
# same math the kernel errs no more than the chain it replaces (rms_norm
# then apply_rope, and autograd of it), in max and in mean, to 0.1%: with
# the rotation off both round the same fp32 values, and a last-bit
# difference can flip one element's rounding either way.
QK_EPS = 1e-6
QK_SLACK = 1.001


def qk_inputs(B, T, H, D, *, Tk=None, rope=True, lanes=0, dtype_name="bfloat16", seed=0):
    """(q, k, wq, wk, cos, sin) on the card: q, k strided views of a fused
    qkv [B, T, 3, H, D] with ``rope``; else q [B, T, H, D] and k a view of
    a fused kv [B, Tk, 2, H, D]. Weights [D], or [lanes, D]."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: (3.0 * torch.randn(s, generator=g, device="cuda")).to(dt)
    wshape = (lanes, D) if lanes else (D,)
    wq, wk = ((1.0 + 0.3 * torch.randn(wshape, generator=g, device="cuda")).to(dt)
              for _ in range(2))
    if not rope:
        return rnd(B, T, H, D), rnd(B, Tk, 2, H, D)[:, :, 0], wq, wk, None, None
    qkv = rnd(B, T, 3, H, D)
    ang = torch.rand((T, D // 2), generator=g, device="cuda") * 60.0
    return qkv[:, :, 0], qkv[:, :, 1], wq, wk, torch.cos(ang), torch.sin(ang)


def _qk_chain(x, w, cos, sin):
    from longcat_video_tta_tpu_torch.ops.layers import apply_rope, rms_norm

    y = rms_norm(x, w, QK_EPS)
    if cos is None:
        return y
    c, s = cos.reshape(1, -1, cos.shape[-1]), sin.reshape(1, -1, sin.shape[-1])
    return apply_rope(y[:, None], c, s)[:, 0]


def _qk_errs(got, ref, truth, chain):
    """Errors of ``got`` against the plain version, and of ``got`` and the
    chain's ``chain`` against the float64 ``truth``."""
    d, r = got.float() - ref.float(), ref.float()
    e_got, e_chain = (got.double() - truth).abs(), (chain.double() - truth).abs()
    return {"max_abs_err": float(d.abs().max()), "max_ref": float(r.abs().max()),
            "l2_rel": float(d.norm() / r.norm()),
            "vs_f64_max": float(e_got.max()), "chain_vs_f64_max": float(e_chain.max()),
            "vs_f64_mean": float(e_got.mean()), "chain_vs_f64_mean": float(e_chain.mean())}


def _qk_gate(name, errs, eps, scale):
    ok = (errs["max_abs_err"] <= scale * eps * errs["max_ref"]
          and errs["l2_rel"] <= scale * eps / 4
          and errs["vs_f64_max"] <= QK_SLACK * errs["chain_vs_f64_max"]
          and errs["vs_f64_mean"] <= QK_SLACK * errs["chain_vs_f64_mean"])
    if not ok:
        raise AssertionError(f"qk prologue {name}: {json.dumps(errs)}")


def _qk_bytes(B, H, D, Ts, esz, bwd):
    """Bytes each launch must move: x read and y written (backward: x, dy
    read, dx written) per side, the cos/sin rows (the first side's tokens)
    once."""
    per = (3 if bwd else 2) * esz * D
    rot = Ts[0][1] * D * 4 if Ts[0][1] else 0
    return sum(B * T * H * per for T, _ in Ts) + rot


def check_qk_case(qn, name, B, T, H, D, *, Tk=None, rope=True, lanes=0, need_k=True,
                  need_w=False, dtype_name="bfloat16", timed=False, seed=0):
    """The forward and backward kernels against their plain versions and a
    float64 evaluation on one shape; returns a result dict."""
    import torch

    q, k, wq, wk, cos, sin = qk_inputs(B, T, H, D, Tk=Tk or T, rope=rope, lanes=lanes,
                                       dtype_name=dtype_name, seed=seed)
    eps = O_EPS[dtype_name]
    res = {"case": name, "B": B, "T": T, "Tk": Tk or T, "H": H, "D": D, "rope": rope,
           "lanes": lanes, "dtype": dtype_name}
    yq, yk = qn._kernel_forward(q, k, wq, wk, cos, sin, QK_EPS)
    torch.cuda.synchronize()
    f64 = lambda t: None if t is None else t.double()
    for side, x, w, y in (("q", q, wq, yq), ("k", k, wk, yk)):
        y_ref = qn.norm_rope_reference(x, w, cos, sin, QK_EPS)
        truth = qn.norm_rope_reference(x.double(), w.double(), f64(cos), f64(sin), QK_EPS)
        errs = _qk_errs(y, y_ref, truth, _qk_chain(x, w, cos, sin))
        _qk_gate(f"{name} forward {side}", errs, eps, 1.0)
        res[f"fwd_{side}"] = errs
        del y_ref, truth
    # the backward: dq always, dk with need_k, dw with need_w
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dyq, dyk = (torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
                for y in (yq, yk))
    need, nw = (True, need_k), (need_w, need_w and need_k)
    dq, dk, dwq, dwk = qn._kernel_backward(q, k, wq, wk, cos, sin, dyq, dyk, QK_EPS, need,
                                           nw)
    torch.cuda.synchronize()
    for side, x, w, dy, dx, dw in (("q", q, wq, dyq, dq, dwq), ("k", k, wk, dyk, dk, dwk)):
        if dx is None:
            continue
        dx_ref, dw_ref = qn.norm_rope_backward_reference(x, w, cos, sin, dy, QK_EPS,
                                                         dw is not None)
        truth, _ = qn.norm_rope_backward_reference(x.double(), w.double(), f64(cos),
                                                   f64(sin), dy.double(), QK_EPS, False)
        xl = x.detach().clone().requires_grad_(True)
        (dx_chain,) = torch.autograd.grad(_qk_chain(xl, w, cos, sin), [xl], [dy])
        errs = _qk_errs(dx, dx_ref, truth, dx_chain)
        if dw is not None:
            errs["dw_l2_rel"] = float((dw - dw_ref.reshape(dw.shape)).norm() / dw_ref.norm())
            if errs["dw_l2_rel"] > 1e-4:
                raise AssertionError(f"qk prologue {name} dw {side}: {json.dumps(errs)}")
        _qk_gate(f"{name} backward {side}", errs, eps, 2.0)
        res[f"bwd_{side}"] = errs
        del dx_ref, truth, dx_chain
    if timed:
        Ts = [(T, T if rope else 0), (Tk or T, 0)]
        esz = q.element_size()
        res["ms"] = _events_ms(lambda: qn._kernel_forward(q, k, wq, wk, cos, sin, QK_EPS),
                               iters=20, warmup=2)
        res["chain_ms"] = _events_ms(lambda: (_qk_chain(q, wq, cos, sin),
                                              _qk_chain(k, wk, cos, sin)), iters=5)
        res["bound_ms"] = _qk_bytes(B, H, D, Ts, esz, False) / H100_BYTES_PER_S * 1e3
        bwd_Ts = Ts if need_k else Ts[:1]
        res["bwd_ms"] = _events_ms(lambda: qn._kernel_backward(
            q, k, wq, wk, cos, sin, dyq, dyk, QK_EPS, need, nw), iters=20, warmup=2)
        res["bwd_bound_ms"] = _qk_bytes(B, H, D, bwd_Ts, esz, True) / H100_BYTES_PER_S * 1e3
        leaves = [x.detach().clone().requires_grad_(n) for x, n in ((q, True), (k, need_k))]
        outs = [_qk_chain(x, w, cos, sin) for x, w in zip(leaves, (wq, wk))]
        res["chain_bwd_ms"] = _events_ms(lambda: torch.autograd.grad(
            outs[:1 + need_k], leaves[:1 + need_k], [dyq, dyk][:1 + need_k],
            retain_graph=True), iters=5)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["bwd_share_of_bound"] = res["bwd_bound_ms"] / res["bwd_ms"]
    return res


def phase_qk_norm_checks(qn, dit_cfg, tokens_per_frame):
    """The q/k prologue's kernels at the main path's shapes (generation's
    self- and cross-attention, 8 latents at B 2; the delta_a train step's,
    7 latents at B 1, cross-attention's k frozen) timed beside the bound
    and the chain they replace, then small cases: rows not a multiple of a
    CTA's 64, head_dims 32 and 64, a lane weight with dw, fp16."""
    import torch

    H, D, L = dit_cfg.num_heads, dit_cfg.head_dim, dit_cfg.text_len
    gen, train = 8 * tokens_per_frame, 7 * tokens_per_frame
    cases = [
        check_qk_case(qn, "gen_self", 2, gen, H, D, timed=True, seed=70),
        check_qk_case(qn, "gen_cross", 2, gen, H, D, Tk=L, rope=False, need_k=False,
                      timed=True, seed=71),
        check_qk_case(qn, "train_self", 1, train, H, D, timed=True, seed=72),
        check_qk_case(qn, "train_cross", 1, train, H, D, Tk=L, rope=False, need_k=False,
                      timed=True, seed=73),
        check_qk_case(qn, "train_self_dw", 1, train, H, D, need_w=True, timed=True,
                      seed=74),
    ]
    torch.cuda.empty_cache()
    cases += [
        check_qk_case(qn, "odd_rows_d128", 1, 37, 3, 128, seed=75),
        check_qk_case(qn, "odd_rows_d64_cross", 2, 41, 5, 64, Tk=7, rope=False, seed=76),
        check_qk_case(qn, "lanes_dw_d128", 4, 53, 3, 128, lanes=2, need_w=True, seed=77),
        check_qk_case(qn, "lanes_dw_d64_fp16", 4, 29, 3, 64, lanes=2, need_w=True,
                      dtype_name="float16", seed=78),
        check_qk_case(qn, "d64_dw", 2, 300, 4, 64, need_w=True, seed=79),
        check_qk_case(qn, "d32", 1, 45, 2, 32, need_w=True, seed=80),
        check_qk_case(qn, "d32_cross", 1, 45, 2, 32, Tk=9, rope=False, need_w=True, seed=81),
    ]
    for c in cases:
        print("[qk-norm] " + json.dumps(c))
    return cases


AGREE_PROMPT = "a ball moving across the scene"


def small_agreement_reference() -> dict:
    """The CPU side of the generate_vc agreement: the longcat_demo bundle
    (seed 3), the inputs, and the plain path's output dense and with every
    decode lever. The levers: 5 cond + 9 generated frames of 64x128 give 2
    + 3 latents of 32 tokens, Sk = 160 in 5 blocks of 32: top_k 4 keeps the
    2 cond blocks and the diagonal and chooses 1 of the 2 others."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import (
        BSAConfig,
        CFGReuseConfig,
        PABConfig,
        longcat_demo,
    )
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc

    cpu = ModelBundle.init_random(longcat_demo(), seed=3, device="cpu")
    rng = np.random.default_rng(0)
    cond = rng.uniform(-1, 1, (1, 3, 5, 64, 128)).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 2, 8, 16)).astype(np.float32))
    dense = dict(num_frames=5, num_inference_steps=2, init_noise=noise)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 3, 8, 16)).astype(np.float32))
    levers = dict(num_frames=9, num_inference_steps=4, init_noise=noise,
                  bsa_cfg=BSAConfig(keep_ratio=0.5, block_q=32, block_k=32),
                  quantize_decode="int8qk", pab_cfg=PABConfig(every=2),
                  cfgr_cfg=CFGReuseConfig(every=2))
    return dict(bundle=cpu, cond=cond,
                runs=[(kw, generate_vc(cpu, cond, AGREE_PROMPT, **kw)) for kw in (dense, levers)])


def phase_small_agreement(ref: dict):
    """generate_vc on the card vs the CPU plain path (``ref``, from
    ``small_agreement_reference``), same weights and noise (longcat_demo
    widths at a small frame size), dense and with the decode levers."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.ops import bsa
    from longcat_video_tta_tpu_torch.pipeline.pipeline import generate_vc

    cpu = ref["bundle"]
    gpu = dataclasses.replace(
        cpu, dit=copy.deepcopy(cpu.dit).cuda(), vae=copy.deepcopy(cpu.vae).cuda(),
        text=copy.deepcopy(cpu.text).cuda(), device=torch.device("cuda"))
    (kw, a), (lever_kw, lever_a) = ref["runs"]
    b = generate_vc(gpu, ref["cond"], AGREE_PROMPT, **kw)
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    psnr = float("inf") if mse == 0 else -10 * math.log10(mse)
    print(f"[agree] longcat_demo generate_vc card vs cpu: shape {b.shape}, "
          f"max|diff| {float(np.abs(a - b).max()):.4g}, psnr {psnr:.2f} dB "
          f"(min {E2E_PSNR_MIN})")
    if not (np.isfinite(b).all() and psnr >= E2E_PSNR_MIN):
        raise AssertionError("card and CPU generate_vc disagree")

    bsa.reset_launches()
    b = generate_vc(gpu, ref["cond"], AGREE_PROMPT, **lever_kw)
    a = lever_a
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


def _step_inputs(cfg, seed: int, delta: bool):
    """The step agreements' numpy inputs: 2 cond + 1 target latents of 8 x
    16, the text, sigma 0.6, the noise (and delta_a's delta), from
    ``default_rng(seed)``; and the text mask (20 tokens)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrays = dict(
        cond=rng.standard_normal((1, 16, 2, 8, 16)),
        target=rng.standard_normal((1, 16, 1, 8, 16)),
        emb=rng.standard_normal((1, cfg.dit.text_len, cfg.dit.text_dim)),
        sigma=np.array([0.6]),
        noise=rng.standard_normal((1, 16, 1, 8, 16)))
    if delta:
        arrays["delta"] = 0.1 * rng.standard_normal((cfg.dit.adaln_tembed_dim,))
    mask = np.ones((1, cfg.dit.text_len), np.int64)
    mask[:, 20:] = 0
    return arrays, mask


def _on(arrays, mask, dev):
    import torch

    return dict(_on_device(arrays, dev), mask=torch.from_numpy(mask).to(dev))


STEP_ARGS = ("cond", "target", "emb", "mask", "sigma", "noise")


def step_agreement_reference() -> dict:
    """The CPU sides of the step agreements on one longcat_demo DiT (seed
    4; its untouched copy is what the card gets): delta_a's step, each
    ``SCHEME_STEPS`` method's step (its trainable tensors too) and DNO's."""
    import copy

    import torch

    from longcat_video_tta_tpu_torch.config import AdapterConfig, longcat_demo
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

    cfg = longcat_demo()
    cpu_dit = ModelBundle.init_random(cfg, seed=4, device="cpu").dit
    out = {"dit": copy.deepcopy(cpu_dit), "schemes": {}}
    a = _on(*_step_inputs(cfg, 1, delta=True), "cpu")
    out["delta_a"] = delta_step(cpu_dit, a["delta"], *(a[k] for k in STEP_ARGS))
    a = _on(*_step_inputs(cfg, 2, delta=False), "cpu")
    for name, kw in SCHEME_STEPS.items():
        scheme = build_scheme(cfg.dit, AdapterConfig(**kw))
        tp_c = scheme.init("cpu", dit=cpu_dit, generator=torch.Generator().manual_seed(5))
        if kw["method"] == "lora":  # b starts at zero: move it so a gets a gradient
            tp_c = {k: v + 0.01 for k, v in tp_c.items()}
        out["schemes"][name] = (tp_c, scheme_step(scheme, cpu_dit, tp_c,
                                                  *(a[k] for k in STEP_ARGS)))
    out["dno"] = dno_grad(cpu_dit, cfg, a)
    return out


def phase_step_agreement(ref: dict):
    """One delta_a train step (loss and delta gradient) on the card vs the
    CPU plain path (``ref``, from ``step_agreement_reference``):
    longcat_demo widths (bf16), same weights, same injected sigma and
    noise; 2 cond + 1 target latents of 8 x 16."""
    from longcat_video_tta_tpu_torch.config import longcat_demo

    gpu_dit = ref["dit"].cuda()
    b = _on(*_step_inputs(longcat_demo(), 1, delta=True), "cuda")
    loss_c, grad_c = ref["delta_a"]
    loss_g, grad_g = delta_step(gpu_dit, b["delta"], *(b[k] for k in STEP_ARGS))
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


# one train step of each other method at longcat_demo width (bf16), card
# vs CPU, and builtin vs side-branch LoRA on the card; the step
# agreement's gates (loss rel 1e-2, gradient cosine >= 0.99)
SCHEME_STEPS = {
    "delta_b_timestep": dict(method="delta_b"),
    "delta_b_hidden": dict(method="delta_b", delta_target="hidden", delta_dim=384,
                           target_blocks="last_4"),
    "delta_c": dict(method="delta_c"),
    "film": dict(method="film", film_mode="shift_scale"),
    "lora": dict(method="lora", lora_target_ffn=True),
    "norm_tune": dict(method="norm_tune", norm_target="all_norm", also_tune_delta=True),
    "full": dict(method="full"),
}


def scheme_step(scheme, dit, tp, cond, target, emb, mask, sigma, noise):
    """Loss and the flattened gradient over every trainable tensor of one
    train step."""
    import torch

    from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    fwd_dit, adapters = scheme.to_forward(leaves, dit)
    loss = flow_matching_loss_conditioned(fwd_dit, cond, target, emb, mask,
                                          adapters=adapters, sigma=sigma, noise=noise)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    flat = torch.cat([(torch.zeros_like(v) if g is None else g).double().flatten().cpu()
                      for v, g in zip(leaves.values(), grads)])
    return float(loss.detach()), flat


def _agree(name, loss_a, grad_a, loss_b, grad_b):
    rel = abs(loss_a - loss_b) / abs(loss_b)
    cos = float((grad_a @ grad_b) / (grad_a.norm() * grad_b.norm()))
    rel_l2 = float((grad_a - grad_b).norm() / grad_b.norm())
    print(f"[agree] {name}: loss {loss_a:.6g} vs {loss_b:.6g} (rel {rel:.3g}, max "
          f"{STEP_LOSS_RTOL}); grad cosine {cos:.6f} (min {STEP_GRAD_COS_MIN}), rel L2 "
          f"{rel_l2:.3g}, |grad| {float(grad_b.norm()):.4g}, {grad_b.numel()} elements")
    if not (rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS_MIN):
        raise AssertionError(f"{name} disagrees")


def dno_grad(dit, cfg, d):
    """DNO: one step's loss and noise gradient through a 2-step sampler."""
    import torch

    from longcat_video_tta_tpu_torch.comparisons import noise_opt

    z = d["noise"].clone().requires_grad_(True)
    gen = noise_opt.sample_from_noise(dit, cfg.scheduler, z, d["cond"], d["emb"],
                                      d["mask"], num_steps=2)
    loss = ((gen - d["target"]) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [z])
    return float(loss.detach()), g.double().flatten().cpu()


def phase_scheme_step_agreement(ref: dict):
    """Each other method's train step (and one DNO step) on the card vs the
    CPU plain path (``ref``), the delta_a step agreement's weights; LoRA
    merged into the weights vs its side branch on the card."""
    import torch

    from longcat_video_tta_tpu_torch.config import AdapterConfig, longcat_demo
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

    cfg = longcat_demo()
    gpu_dit = ref["dit"].cuda()
    b = _on(*_step_inputs(cfg, 2, delta=False), "cuda")
    for name, kw in SCHEME_STEPS.items():
        scheme = build_scheme(cfg.dit, AdapterConfig(**kw))
        tp_c, (loss_c, grad_c) = ref["schemes"][name]
        tp_g = (scheme.init("cuda", dit=gpu_dit) if kw["method"] in ("norm_tune", "full")
                else {k: v.cuda() for k, v in tp_c.items()})
        loss_g, grad_g = scheme_step(scheme, gpu_dit, tp_g, *(b[k] for k in STEP_ARGS))
        _agree(f"longcat_demo {name} step card vs cpu", loss_g, grad_g, loss_c, grad_c)
        if kw["method"] == "lora":
            merged = build_scheme(cfg.dit, AdapterConfig(**kw, lora_builtin=True))
            loss_m, grad_m = scheme_step(merged, gpu_dit, tp_g, *(b[k] for k in STEP_ARGS))
            _agree("longcat_demo lora merged vs side branch on the card", loss_m, grad_m,
                   loss_g, grad_g)
        torch.cuda.empty_cache()
    _agree("longcat_demo dno step (2 sampler steps) card vs cpu", *dno_grad(gpu_dit, cfg, b),
           *ref["dno"])


def phase_main_path(fa, depth):
    """Serving through ``runners/run_baseline.main`` (the runner's --method
    none plus per_video_metrics.csv)."""
    import csv

    import numpy as np

    from longcat_video_tta_tpu_torch.runners import run_baseline

    out_dir = os.path.join(RUN_DIR, "run")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--preset", "longcat_13b",
            "--synthetic", str(MAIN["requests"]), "--output-dir", out_dir,
            "--device", "cuda", "--height", str(MAIN["height"]),
            "--width", str(MAIN["width"]),
            "--num-cond-frames", str(MAIN["cond_frames"]),
            "--num-frames", str(MAIN["gen_frames"]),
            "--num-inference-steps", str(MAIN["steps"]),
            "--guidance-scale", str(MAIN["guidance"]), "--no-save-videos"]
    print("[main] run_baseline " + " ".join(argv))
    print(f"[main] geometry: {MAIN}; cuts: none (full depth {depth}, full widths)")
    fa.reset_launches()
    t0 = time.time()
    summary = run_baseline.main(argv)
    wall = time.time() - t0
    launches = fa.launches
    with open(os.path.join(out_dir, "per_video_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
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
    if (summary["method"] != "none" or len(rows) != MAIN["requests"]
            or list(rows[0]) != run_baseline.CSV_COLUMNS
            or not all(np.isfinite(float(x["psnr"])) for x in rows)):
        raise AssertionError(f"per_video_metrics.csv: {rows}")
    print(f"[main] per_video_metrics.csv: {len(rows)} rows, columns {list(rows[0])}")
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


# [longhorizon]: scripts/measure_longhorizon's 93-frame decode at its own
# geometry (longcat_bench at full width and 16 blocks; 4 cond + 24
# generated latents of 60 x 104), 10 denoising steps (not 50) in
# segments of 5, W8A8 and BSA keep 0.15 (top_k 8 of 43 key blocks). corr
# holds that stack to the reference's fidelity target (its docstring's
# latent corr >= 0.999 for the BSA keep ratio); wall adds int8 QK^T and
# the rest of ARCHITECTURE.md's long-horizon setting, PAB every 4 and CFG
# reuse every 2 over [0.06, 0.96). With PAB and CFG reuse in corr too,
# the 10-step corr read 0.99891 on an H100 (0.99964 at 50 steps, PERF.md
# §5): over 10 steps PAB reuses attention across 5x larger sigma jumps
LONGHORIZON = dict(steps=10, segment=5, keep=0.15, corr_min=0.999, seed=71)
LONGHORIZON_FLAGS = {
    "corr": (),
    "wall": ("--int8qk", "--pab-every", "4", "--pab-start", "0.06", "--pab-end", "0.96",
             "--cfg-reuse-every", "2", "--cfg-reuse-start", "0.06", "--cfg-reuse-end", "0.96"),
}


def longhorizon_argv(mode: str, *extra):
    L = LONGHORIZON
    return ["--mode", mode, "--keep", str(L["keep"]), "--steps", str(L["steps"]),
            "--segment", str(L["segment"]), *LONGHORIZON_FLAGS[mode], "--device", "cuda",
            *extra]


def longhorizon_launches(args, depth: int) -> dict:
    """Launches per kernel of one ``measure_longhorizon`` run (``args``: its
    parsed flags). Each sampler call runs the cond-cache precompute's self-
    and cross-attention on the forward kernel (2 x depth), and at every
    step each block's cross-attention on it (depth). The dense decode
    (corr's reference) runs self-attention on it too at every step; the
    lever stack runs it through BSA (depth, two block sums each; int8-QK
    with --int8qk) on the steps PAB computes: every step without PAB, else
    those outside [round(start * steps), round(end * steps)) and every
    ``every``-th one from its start. CFG reuse halves a step's batch, not
    its launches. corr: one dense and one lever call; wall: two lever
    calls."""
    steps = args.steps
    attn_steps = steps
    if args.pab_every > 0:
        start, end = round(args.pab_start * steps), round(args.pab_end * steps)
        attn_steps = sum(1 for i in range(steps)
                         if not (start <= i < end and (i - start) % args.pab_every))
    calls = 1 if args.mode == "corr" else 2
    out = {"flash_fwd": calls * depth * (2 + steps), "bsa_fwd": 0, "bsa_fwd_qk_int8": 0,
           "bsa_block_sum": calls * 2 * depth * attn_steps}
    out["bsa_fwd_qk_int8" if args.int8qk else "bsa_fwd"] = calls * depth * attn_steps
    if args.mode == "corr":
        out["flash_fwd"] += depth * (2 + 2 * steps)
    return out


def longhorizon_geometry(dit_cfg):
    """(tokens per latent frame, cond tokens, query tokens, key tokens) of
    measure_longhorizon's decode: 1560, 6240, 37 440, 43 680."""
    from longcat_video_tta_tpu_torch.scripts import measure_longhorizon as mlh

    gen_latents = mlh.parse_args([]).gen_latents
    tpf = (mlh.LAT_H // dit_cfg.patch_size[1]) * (mlh.LAT_W // dit_cfg.patch_size[2])
    ncond, sq = mlh.COND_LATENTS * tpf, gen_latents * tpf
    return tpf, ncond, sq, ncond + sq


def phase_longhorizon_kernels(fa, bsa, dit_cfg):
    """B1, B4 and B5 at the 93-frame decode's shapes against their plain
    versions, timed: B1 at the dense decode (the CFG pair, 37 440 queries
    against 6240 cached + 37 440 fresh keys, both ragged in 1024-token
    blocks, the query offset inside a block) against SDPA; the block sums
    over the queries and the keys against ``view().sum(2)``; BSA 16-bit at
    top_k 8 (keep 0.15, the forced-keep clamp) and 16 (keep 0.35) against
    compiled flex_attention on the same selection, int8-QK at top_k 8."""
    import torch

    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    _, ncond, sq, sk = longhorizon_geometry(dit_cfg)
    seed = LONGHORIZON["seed"]
    cases = [check_kernel_case(fa, "longhorizon_decode", 2, H, sq, sk, D, timed=True,
                               seed=seed)]
    torch.cuda.empty_cache()
    bsa_cases = []
    for top_k, int8 in ((8, False), (16, False), (8, True)):
        bsa_cases.append(check_bsa_case(fa, bsa, f"longhorizon_top{top_k}", 2, H, sq, sk, D,
                                        top_k=top_k, ncond=ncond, qk_int8=int8, timed=True,
                                        seed=seed + top_k))
        torch.cuda.empty_cache()
    sums = [check_block_sum_case(bsa, "longhorizon_pool_q", 2, sq, H, D, 1024, timed=True,
                                 seed=seed + 20),
            check_block_sum_case(bsa, "longhorizon_pool_k", 2, sk, H, D, 1024, timed=True,
                                 seed=seed + 21)]
    for c in cases:
        print("[longhorizon-kernel] " + json.dumps(c))
    for c in bsa_cases + sums:
        print("[longhorizon-bsa-kernel] " + json.dumps(c))
    return cases, bsa_cases, sums


def phase_longhorizon_runs(fa, bsa, cfg):
    """``measure_longhorizon`` at its geometry, corr (the dense bf16 decode,
    then W8A8 + BSA) and wall (two runs with int8 QK^T, PAB and CFG
    reuse as well): finite latents of the 93-frame shape, latent corr >=
    0.999, launches equal to ``longhorizon_launches``. Returns the
    launches of both runs, summed."""
    import torch

    from longcat_video_tta_tpu_torch.scripts import measure_longhorizon as mlh

    _, ncond, sq, sk = longhorizon_geometry(cfg.dit)
    total = {}
    for mode in LONGHORIZON_FLAGS:
        args = mlh.parse_args(longhorizon_argv(mode))
        bsa_cfg = mlh.lever_configs(args)[0]
        print(f"[longhorizon {mode}] measure_longhorizon " + " ".join(longhorizon_argv(
            mode)) + f"; top_k {mlh.clamped_top_k(bsa_cfg, sk, ncond)} of "
            f"{-(-sk // bsa_cfg.block_k)} key blocks; cuts: {args.steps} denoising steps "
            f"(not 50); full width and depth {cfg.dit.depth}")
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        bsa.reset_launches()
        t0 = time.time()
        record, latents = mlh.measure_longhorizon(args, cfg, device="cuda")
        wall = time.time() - t0
        got = {"flash_fwd": fa.launches, "bsa_fwd": bsa.bsa_launches,
               "bsa_fwd_qk_int8": bsa.bsa_int8_launches,
               "bsa_block_sum": bsa.bsa_block_sum_launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = longhorizon_launches(args, cfg.dit.depth)
        print(f"[longhorizon] {json.dumps(record)}")
        print(f"[longhorizon {mode}] wall {wall:.1f} s; max_memory_allocated {peak:.2f} GiB; "
              f"launches {got} (expected {expected})")
        shape = (1, cfg.dit.out_channels, args.gen_latents, mlh.LAT_H, mlh.LAT_W)
        for x in latents:
            if tuple(x.shape) != shape or not bool(x.isfinite().all()):
                raise AssertionError(f"[longhorizon {mode}] latents {tuple(x.shape)} "
                                     f"(expected {shape}), finite "
                                     f"{bool(x.isfinite().all())}")
        if mode == "corr" and not record["latent_corr"] >= LONGHORIZON["corr_min"]:
            raise AssertionError(f"[longhorizon] latent corr {record['latent_corr']} < "
                                 f"{LONGHORIZON['corr_min']}")
        if got != expected:
            raise AssertionError(f"[longhorizon {mode}] launches {got}, expected {expected}")
        del latents
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
    return total


def phase_longhorizon(fa, bsa):
    from longcat_video_tta_tpu_torch.config import longcat_bench

    cfg = longcat_bench()
    kernels = phase_longhorizon_kernels(fa, bsa, cfg.dit)
    return (*kernels, phase_longhorizon_runs(fa, bsa, cfg))


# [bench]: scripts/bench's sections at the root bench.py's geometry
# (longcat_bench at full width and 16 blocks; latents of 60 x 104: a
# 4680-token train sequence behind a 3120-token prefix, and 4 cond + 8
# generated latents, 12 480 queries against 6240 cached + 12 480 fresh
# keys), scale 2 at its 24 blocks, the flagship block at depths 1 and 2.
# Only the step counts are cut (``counts``). The BSA and W8A8 + BSA
# forms are held to the dense form from the same initial noise at
# measure_longhorizon's fidelity target; the PAB forms' corr is printed,
# not gated: at few steps PAB reuses attention across large sigma jumps
# (see LONGHORIZON)
BENCH = dict(counts=dict(steps=2, gen_steps=4, vp_lanes=2, vp_steps=2, scale2_steps=1,
                         scale2_gen_steps=2, scale3_steps=1),
             corr_min=0.999, gated_forms=("bsa", "int8_bsa"), seed=121)


def bench_geometry():
    """(train tokens, their prefix, decode queries, decode keys, cached keys)
    of scripts/bench: 4680, 3120, 12 480, 18 720, 6240."""
    from longcat_video_tta_tpu_torch.scripts import bench as bench_script

    tpf, s_train = bench_script.token_counts(bench_script.LAT_H, bench_script.LAT_W)
    cached = bench_script.COND_LATENTS * tpf
    sq = bench_script.GEN_LATENTS * tpf
    return s_train, bench_script.CONTEXT_LATENTS * tpf, sq, cached + sq, cached


def _remat(dc) -> str:
    return dc.remat_policy if dc.remat else "none"


def bench_launches(counts, dit_cfg, dit2_cfg, flagship_cfg) -> dict:
    """Launches per kernel of ``scripts.bench.run`` at ``counts``:
      - delta_a and LoRA r1: 1 + steps train steps each, under the model's
        remat policy ("t_embed"; LoRA's default sites include the
        cross-attention's kv: "cross_kv");
      - V lanes: each batched step launches what one video's step does
        (the lanes ride the batch axis), vp_steps a chunk, a warm-up chunk
        and a timed one;
      - each continuation form: two sampler calls; the dense one runs the
        cond cache's self- and cross-attention and both at every step; a
        lever form as ``longhorizon_launches``'s wall mode (two calls, BSA
        self-attention on the steps PAB computes);
      - scale 2: 1 + scale2_steps train steps under its full remat, two
        dense sampler calls of scale2_gen_steps;
      - scale 3: 1 + scale3_steps train steps at depths 1 and 2."""
    import argparse

    from longcat_video_tta_tpu_torch.scripts import bench as bench_script

    out = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "bsa_fwd",
                          "bsa_fwd_qk_int8", "bsa_block_sum")}

    def add(launches, times=1):
        for k, n in launches.items():
            out[k] += times * n

    d, steps, g = dit_cfg.depth, counts["steps"], counts["gen_steps"]
    add(train_step_launches("t_embed", d, _remat(dit_cfg)), 1 + steps)
    add(train_step_launches("cross_kv", d, _remat(dit_cfg)), 1 + steps)
    add(train_step_launches("t_embed", d, _remat(dit_cfg)), 2 * counts["vp_steps"])
    start, end = bench_script.LEVER_RANGE
    for form, spec in bench_script.FORMS.items():
        if not spec.get("bsa"):
            add({"flash_fwd": 2 * d * (1 + g)}, 2)
            continue
        args = argparse.Namespace(mode="wall", steps=g, pab_every=4 if spec.get("pab") else 0,
                                  pab_start=start, pab_end=end, int8qk=False)
        add(longhorizon_launches(args, d))
    d2, g2 = dit2_cfg.depth, counts["scale2_gen_steps"]
    add(train_step_launches("t_embed", d2, _remat(dit2_cfg)), 1 + counts["scale2_steps"])
    add({"flash_fwd": 2 * d2 * (1 + g2)}, 2)
    for depth in (1, 2):
        add(train_step_launches("t_embed", depth, _remat(flagship_cfg)),
            1 + counts["scale3_steps"])
    return out


def reference_bench_keys(counts):
    """(top-level keys, detail keys) of the root bench.py's JSON line as its
    source writes them (bench.py:408-471, with the dicts it spreads in:
    vp_detail :224-226, scale2 :323-333, scale3 :380-389), at ``counts``'
    step counts and lanes, with the port's two changes: the ``device`` key,
    and no gen_93frame_50step_s_recorded (a recorded number of another
    run)."""
    import ast

    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    env = dict(V=counts["vp_lanes"], g2_steps=counts["scale2_gen_steps"])

    def key(node):
        if isinstance(node, ast.Constant):
            return node.value
        return eval(compile(ast.Expression(node), "bench.py", "eval"), {}, env)

    spread, line = {}, None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and node.value.keys:
            spread[node.targets[0].id] = [key(k) for k in node.value.keys]
        elif isinstance(node, ast.Assign) and getattr(
                getattr(node.targets[0], "value", None), "id", "") == "vp_detail":
            spread.setdefault("vp_detail", []).append(key(node.targets[0].slice))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps":
            line = node.args[0]
    top = [k.value for k in line.keys]
    detail_dict = line.values[top.index("detail")]
    detail = []
    for k, v in zip(detail_dict.keys, detail_dict.values):
        detail += spread[v.id] if k is None else [k.value]
    top.insert(top.index("detail"), "device")
    detail = [k.replace("_50step_", f"_{counts['gen_steps']}step_") for k in detail
              if k != "gen_93frame_50step_s_recorded"]
    return top, detail


def phase_bench_kernels(fa, bsa, dit_cfg):
    """B1, B4 and B5 at scripts/bench's decode (B 2, 16 heads: 12 480 queries
    against 6240 cached + 12 480 fresh keys), B1-B3 at its train step (4680
    tokens behind a 3120-token prefix, and the cross-attention against 512
    text tokens, whose dK/dV LoRA's step launches), each against its plain
    version and timed beside SDPA (B5: compiled flex_attention on the same
    selection at keep 0.35's clamped top_k; B4: ``view().sum(2)``)."""
    from longcat_video_tta_tpu_torch.config import BSAConfig
    from longcat_video_tta_tpu_torch.scripts import bench as bench_script
    from longcat_video_tta_tpu_torch.scripts import measure_longhorizon as mlh

    H, D, L = dit_cfg.num_heads, dit_cfg.head_dim, dit_cfg.text_len
    s_train, n_ctx, sq, sk, cached = bench_geometry()
    seed = BENCH["seed"]
    fwd = [check_kernel_case(fa, "bench_decode", 2, H, sq, sk, D, timed=True, seed=seed),
           check_kernel_case(fa, "bench_train_self", 1, H, s_train, s_train, D, ncond=n_ctx,
                             timed=True, seed=seed + 1),
           check_kernel_case(fa, "bench_train_cross", 1, H, s_train, L, D, fused_kv=True,
                             timed=True, seed=seed + 2)]
    bwd = check_bwd_case(fa, "bench_train_self", 1, H, s_train, s_train, D, ncond=n_ctx,
                         timed=True, seed=seed + 3)
    bwd += check_bwd_case(fa, "bench_train_cross", 1, H, s_train, L, D, fused_kv=True,
                          timed=True, seed=seed + 4)
    top_k = mlh.clamped_top_k(BSAConfig(keep_ratio=bench_script.BSA_KEEP), sk, cached)
    sparse = [check_bsa_case(fa, bsa, f"bench_top{top_k}", 2, H, sq, sk, D, top_k=top_k,
                             ncond=cached, timed=True, seed=seed + 5)]
    sums = [check_block_sum_case(bsa, "bench_pool_q", 2, sq, H, D, 1024, timed=True,
                                 seed=seed + 6),
            check_block_sum_case(bsa, "bench_pool_k", 2, sk, H, D, 1024, timed=True,
                                 seed=seed + 7)]
    for tag, rows in (("kernel", fwd), ("bwd-kernel", bwd), ("bsa-kernel", sparse + sums)):
        for c in rows:
            print(f"[bench-{tag}] " + json.dumps(c))
    return fwd, bwd, sparse, sums


def phase_bench_runs(fa, bsa, cfg, *, cfg2=None, flagship=None, geometry=None,
                     card: str = "cuda"):
    """``scripts.bench.run`` at ``BENCH["counts"]``, its continuation forms
    from one pair of initial noises: finite losses and latents of their
    shapes, the gated forms' latent corr against the dense form, every key
    of the reference's line present and none null, the card's MFU peak,
    launches equal to ``bench_launches``. Returns the launches. ``cfg2``,
    ``flagship``, ``geometry`` and ``card`` (a CPU rehearsal at tiny size):
    the script's unless given."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import longcat_bench_3b
    from longcat_video_tta_tpu_torch.scripts import bench as bench_script

    counts = BENCH["counts"]
    cfg2 = longcat_bench_3b() if cfg2 is None else cfg2
    flagship = bench_script.flagship_config() if flagship is None else flagship
    geo = dict(bench_script.GEOMETRY if geometry is None else geometry)
    cuts = {k: f"{bench_script.COUNTS[k]} -> {v}" for k, v in counts.items()
            if bench_script.COUNTS[k] != v}
    print(f"[bench] scripts.bench.run at longcat_bench (full width, depth {cfg.dit.depth}), "
          f"latents {geo['lat_h']} x {geo['lat_w']}; scale 2 at depth "
          f"{cfg2.dit.depth}, the flagship block at depths 1 and 2; cuts (the script's -> "
          f"here): {cuts}")
    peak = bench_script.peak_flops(card)
    if peak != H100_BF16_FLOPS:
        raise AssertionError(f"[bench] MFU peak {peak}, the card's is {H100_BF16_FLOPS}")
    g = torch.Generator(device=card).manual_seed(BENCH["seed"] + 10)
    shape = (1, cfg.dit.in_channels, bench_script.GEN_LATENTS, geo["lat_h"], geo["lat_w"])
    noises = [torch.randn(shape, generator=g, device=card) for _ in range(2)]
    if card == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    bsa.reset_launches()
    t0 = time.time()
    rec, outs = bench_script.run(card, peak=peak, card=bench_script.device_info(), cfg=cfg,
                                 cfg2=cfg2, flagship=flagship, counts=counts, geometry=geo,
                                 init_noises=noises, log=lambda line: print(f"[bench] {line}"))
    wall = time.time() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 if card == "cuda" else 0.0
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches, "bsa_fwd": bsa.bsa_launches,
           "bsa_fwd_qk_int8": bsa.bsa_int8_launches,
           "bsa_block_sum": bsa.bsa_block_sum_launches}
    expected = bench_launches(counts, cfg.dit, cfg2.dit, flagship)
    print(f"[bench] {json.dumps(rec)}")
    print(f"[bench] wall {wall:.1f} s; max_memory_allocated {peak_gib:.2f} GiB; launches "
          f"{got} (expected {expected})")
    steps, lanes = counts["steps"], counts["vp_lanes"]
    losses = [(outs["delta_a"]["losses"], (1 + steps,)), (outs["lora"]["losses"], (1 + steps,)),
              (outs["vp"]["losses"], (lanes, 2 * counts["vp_steps"])),
              (outs["scale2"]["losses"], (1 + counts["scale2_steps"],))]
    losses += [(x, (1 + counts["scale3_steps"],)) for x in outs["scale3"]["losses"].values()]
    for x, want in losses:
        if tuple(x.shape) != want or not bool(x.isfinite().all()):
            raise AssertionError(f"[bench] losses {x.tolist()} (expected shape {want})")
    lat_shape = (1, cfg.dit.out_channels) + shape[2:]
    runs = list(outs["gen"]["latents"].items()) + [("scale2", outs["scale2"]["latents"])]
    for form, pair in runs:
        for x in pair:
            if tuple(x.shape) != lat_shape or not bool(x.isfinite().all()):
                raise AssertionError(f"[bench] {form} latents {tuple(x.shape)} (expected "
                                     f"{lat_shape}), finite {bool(x.isfinite().all())}")
    dense = outs["gen"]["latents"]["dense"][1].double().cpu().numpy().ravel()
    for form, (_, x) in outs["gen"]["latents"].items():
        if form == "dense":
            continue
        corr = float(np.corrcoef(dense, x.double().cpu().numpy().ravel())[0, 1])
        gated = form in BENCH["gated_forms"]
        print(f"[bench] {form} vs dense from the same initial noise: latent corr {corr:.5f}"
              + (f" (min {BENCH['corr_min']})" if gated else " (not gated)"))
        if gated and not corr >= BENCH["corr_min"]:
            raise AssertionError(f"[bench] {form} latent corr {corr} < {BENCH['corr_min']}")
    top, detail = reference_bench_keys(counts)
    nulls = [k for k, v in rec["detail"].items() if v is None] + [
        k for k, v in rec.items() if v is None]
    if list(rec) != top or list(rec["detail"]) != detail or nulls:
        raise AssertionError(f"[bench] keys {list(rec)} / {list(rec['detail'])}, expected "
                             f"{top} / {detail}; null: {nulls}")
    if got != expected:
        raise AssertionError(f"[bench] launches {got}, expected {expected}")
    return got


def phase_bench(fa, bsa):
    from longcat_video_tta_tpu_torch.config import longcat_bench

    cfg = longcat_bench()
    kernels = phase_bench_kernels(fa, bsa, cfg.dit)
    return (*kernels, phase_bench_runs(fa, bsa, cfg))


def t2v_launches(depth: int, steps: int, pab_every: int = 0,
                 cfg_reuse_every: int = 0) -> int:
    """Forward-kernel launches of one text-to-video request: no
    conditioning latents, so no cond cache; every denoising step runs each
    block's cross-attention, and its self-attention unless PAB reuses it:
    with ``pab_every`` k, inside [round(0.1 * steps), round(0.9 * steps))
    (PABConfig's range) the steps whose offset from the range start is
    not a multiple of k reuse. CFG reuse halves a step's batch (the
    conditional row alone), not its launches."""
    del cfg_reuse_every  # the batch, not the count
    start, end = round(0.1 * steps), round(0.9 * steps)
    reused = sum(1 for i in range(steps)
                 if pab_every > 0 and start <= i < end and (i - start) % pab_every)
    return depth * (2 * steps - reused)


def tta_split(holdout: float = 0.25):
    """(cond, train, val) latents of the TTA window, as the runner splits
    it (tta/split.py); DNO splits at holdout 0."""
    from longcat_video_tta_tpu_torch.tta.split import estimate_tta_split_budget

    s = estimate_tta_split_budget(TTA["tta_total_frames"],
                                  min(TTA["cond_frames"], TTA["tta_total_frames"]),
                                  holdout)
    return s["cond_latents"], s["train_latents"], s["val_latents"]


def train_step_launches(graph: str, depth: int, policy: str = "full"):
    """Launches per kernel of one train step with full remat (2 attention
    calls per block), by where the trainable tensors enter the graph. A
    block whose inputs depend on no trainable tensor runs once and is not
    recomputed; an attention runs the dQ kernel when its q needs a
    gradient and the dK/dV kernel when its k or v does:
      "t_embed"    (delta_a, delta_b timestep, film): every block, each
                   recomputed (forward 4 x depth); dQ for self- and cross-
                   attention; dK/dV for self-attention only (cross-
                   attention's k, v come from the frozen text path);
      "cross_kv"   (LoRA on xattn_kv, norm_tune qk_norm / all_norm, full):
                   as t_embed, and cross-attention's k, v need a gradient
                   too: dK/dV 2 x depth;
      "cross_norm" (norm_tune cross_attn_norm): block 0's self-attention
                   comes before the first trainable tensor (its
                   pre_crs_norm): no backward for it;
      "hidden"     (delta_b hidden): the first trainable tensor is added
                   after block 0, which is neither recomputed nor
                   backpropagated (a last_N mask multiplies by 0 but does
                   not cut the graph);
      "output"     (delta_c): the gradient stops at the output residual:
                   the forward alone.
    DNO's sampler step is a "t_embed" step: its noise reaches every
    attention's q, and self-attention's k and v. Under the "dots" policy
    the attention forward is recomputed as under "full"; under
    "dots_attn" its o and lse are kept, so each attention runs forward
    once (2 x depth) and the backward counts do not change; so it does
    without remat ("none": longcat_demo's remat=False)."""
    d = depth
    fwd, dq, dkv = {
        "t_embed": (4 * d, 2 * d, d),
        "cross_kv": (4 * d, 2 * d, 2 * d),
        "cross_norm": (4 * d, 2 * d - 1, d - 1),
        "hidden": (2 * d + 2 * (d - 1), 2 * (d - 1), d - 1),
        "output": (2 * d, 0, 0),
    }[graph]
    if policy in ("dots_attn", "none"):
        fwd = 2 * d
    return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}


def tta_launches(depth: int):
    """Launches per kernel that the delta_a path implies for one video: a
    "t_embed" train step per step, an anchor eval at setup and one per
    check (steps // check_every, no early stop since patience exceeds the
    number of checks), then generation."""
    steps, checks = TTA["tta_steps"], TTA["tta_steps"] // TTA["check_every"]
    assert checks < TTA["patience"]
    return method_launches("t_embed", depth, steps=steps, anchors=1 + checks,
                           inference_steps=TTA["inference_steps"])


def method_launches(graph: str, depth: int, *, steps: int, anchors: int,
                    inference_steps: int, sampler_steps: int = 1, policy: str = "full"):
    """Launches per kernel of one video of a method run: ``steps`` train
    steps (a DNO step backpropagates through ``sampler_steps`` sampler
    steps), ``anchors`` anchor evals (one batched forward each), then
    generation (cond-cache precompute plus one decode per step)."""
    per_step = train_step_launches(graph, depth, policy)
    out = {k: steps * sampler_steps * n for k, n in per_step.items()}
    out["flash_fwd"] += 2 * depth * (anchors + 1 + inference_steps)
    return out


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


# method runs: the runner on 1 video per method at LongCat-13.6B width and
# 24 of its 48 blocks (full: longcat_bench_3b, whose full-weight TTA state
# fits the card), delta_a's 29-frame window, 3 TTA steps with the anchor check
# every 3, 2 denoising steps, 8 generated frames, each at its learning rate
# in the demo campaign (campaign/demo/_<method>.yaml; full and lora: their
# longer variant's). "graph" names where the trainable tensors enter the
# model (train_step_launches).
METHOD = dict(height=480, width=832, cond_frames=13, tta_total_frames=29, gen_frames=8,
              steps=3, check_every=3, inference_steps=2, guidance=4.0, depth=24)
METHOD_RUNS = {
    "lora": dict(graph="cross_kv", lr=1e-3, flags=["--lora-target-ffn",
                                                    "--quantize-decode", "int8"]),
    "delta_b": dict(graph="hidden", lr=5e-3, flags=[
        "--delta-target", "hidden", "--delta-dim", "2048", "--target-blocks", "last_24"]),
    "delta_c": dict(graph="output", lr=1e-2, flags=[]),
    "film": dict(graph="t_embed", lr=1e-3, flags=["--film-mode", "shift_scale"]),
    "norm_tune": dict(graph="cross_kv", lr=1e-3, flags=["--norm-target", "all_norm",
                                                        "--also-tune-delta"]),
    "full": dict(graph="cross_kv", lr=1e-4, flags=[], preset="longcat_bench_3b"),
    "dno": dict(graph="t_embed", lr=1e-2, flags=["--dno-sampler-steps", "2",
                                                 "--dno-interp-every", "1"],
                steps=2, sampler_steps=2),
}


def method_trainable(method: str, dit_cfg) -> int:
    """The trainable-parameter count each method run must report, from the
    model's widths (the reference's counting)."""
    import torch

    from longcat_video_tta_tpu_torch.models.dit import LongCatDiT

    D, dh, F, L = dit_cfg.hidden_size, dit_cfg.head_dim, dit_cfg.ffn_dim, dit_cfg.depth
    r = 8
    if method == "lora":  # qkv, proj and the ffn, 8 sites, every block
        sites = [(D, 3 * D), (D, D), (D, D), (D, 2 * D), (D, D), (D, F), (F, D), (D, F)]
        return L * sum(i * r + r * o for i, o in sites)
    if method == "delta_b":  # 4 groups + the final delta, 2048 dims each
        return 5 * 2048
    if method == "delta_c":
        return dit_cfg.out_channels
    if method == "film":  # 4 groups x shift and scale of both halves
        return 4 * 4 * D
    if method == "norm_tune":  # all_norm + the delta_a vector
        return L * (2 * D + 4 * dh) + dit_cfg.adaln_tembed_dim
    if method == "full":
        with torch.device("meta"):
            return sum(p.numel() for p in LongCatDiT(dit_cfg).parameters())
    from longcat_video_tta_tpu_torch.tta.split import estimate_tta_split_budget

    # dno: the initial noise of the window's train latents (split at holdout 0)
    n_train = estimate_tta_split_budget(METHOD["tta_total_frames"], METHOD["cond_frames"],
                                        0.0)["train_latents"]
    return dit_cfg.in_channels * n_train * (METHOD["height"] // 8) * (METHOD["width"] // 8)


def phase_method_path(fa, method: str):
    """One video of ``method`` through the runner: on LongCat-13.6B at
    ``METHOD["depth"]`` of its 48 blocks (full width), ``full`` on
    longcat_bench_3b."""
    import contextlib

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch import config
    from longcat_video_tta_tpu_torch.runners import run_tta

    spec = METHOD_RUNS[method]
    preset = spec.get("preset", "longcat_13b")
    cut = (preset_depth(METHOD["depth"], preset) if preset == "longcat_13b"
           else contextlib.nullcontext())
    with cut:
        dit_cfg = config.get_model_config(preset).dit  # the cut, as the runner reads it
        steps = spec.get("steps", METHOD["steps"])
        out_dir = os.path.join(RUN_DIR, f"method_{method}")
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = ["--method", method, "--preset", preset, "--synthetic", "1",
                "--output-dir", out_dir, "--device", "cuda",
                "--height", str(METHOD["height"]), "--width", str(METHOD["width"]),
                "--num-cond-frames", str(METHOD["cond_frames"]),
                "--tta-total-frames", str(METHOD["tta_total_frames"]),
                "--num-frames", str(METHOD["gen_frames"]), "--steps", str(steps),
                "--lr", str(spec["lr"]),
                "--es-check-every", str(METHOD["check_every"]),
                "--num-inference-steps", str(METHOD["inference_steps"]),
                "--guidance-scale", str(METHOD["guidance"]), "--no-save-videos",
                # one video: its caption is the whole caption set
                "--caption-guard-mode", "off", *spec["flags"]]
        print(f"[method {method}] run_tta " + " ".join(argv))
        is_dno = method == "dno"
        expected = method_launches(
            spec["graph"], dit_cfg.depth, steps=steps,
            anchors=0 if is_dno else 1 + steps // METHOD["check_every"],
            inference_steps=METHOD["inference_steps"],
            sampler_steps=spec.get("sampler_steps", 1))
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        fa.reset_launches()
        t0 = time.time()
        summary = run_tta.main(argv)
        wall = time.time() - t0
        got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
               "flash_bwd_dkv": fa.bwd_dkv_launches}
        shutil.rmtree(os.path.join(out_dir, "synthetic_data"), ignore_errors=True)
        r = summary["results"][0]
        es = r.get("early_stopping_info") or {}
        anchors = [loss for _, loss in es.get("loss_history", [])]
        n_train = method_trainable(method, dit_cfg)
        print(f"[method {method}] success={r['success']} preset={preset} "
              f"train_time={r.get('train_time')} s es_check_time={r.get('es_check_time')} s "
              f"gen_time={r.get('gen_time')} s total_time={r.get('total_time')} s "
              f"losses={r.get('losses')} anchors={anchors} best_step={es.get('best_step')} "
              f"adapter_norm={r.get('adapter_norm')} noise_norm={r.get('noise_norm')} "
              f"trainable_params={r.get('trainable_params')} (expected {n_train}) "
              f"psnr={r.get('psnr')} ssim={r.get('ssim')}"
              + (f" error={r['error']}" if "error" in r else ""))
        print(f"[method {method}] wall {wall:.1f} s; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({held:.2f} held before "
              f"the run); launches {got} "
              f"(expected {expected})")
        if summary["num_success"] != 1:
            raise AssertionError(f"method run {method} failed: {r.get('error')}")
        losses = r["losses"]
        if not (np.isfinite(losses + anchors + [r["psnr"], r["ssim"]]).all()
                and len(losses) == steps):
            raise AssertionError(f"method run {method}: non-finite or missing values: {r}")
        # the trained state moved: DNO's loss is deterministic in the noise,
        # and the anchor loss (fixed sigmas and noises) in the adapted model
        moved = losses[-1] != losses[0] if is_dno else (len(anchors) == 2
                                                        and anchors[1] != anchors[0])
        if not moved or r["trainable_params"] != n_train:
            raise AssertionError(f"method run {method}: did not train, or reports "
                                 f"{r['trainable_params']} trainable parameters ({n_train})")
        if got != expected:
            raise AssertionError(f"kernel launches on the {method} run {got}, "
                                 f"expected {expected}")
        return got


# ---------------------------------------------------------------------------
# Checkpoint path: a LongCat-layout folder drawn on the card, loaded through
# the runner's --checkpoint-dir
# ---------------------------------------------------------------------------

CKPT = dict(seed=11, shard_bytes=5 * 10 ** 9, rss_every_s=0.05)


def synth_value(key: str, shape, gen, device="cuda"):
    """A bf16 tensor for one upstream key, drawn on the card: biases
    N(0, 0.02), norm scales N(1, 0.02), the UMT5 embedding N(0, 1), its
    relative-attention tables N(0, 0.1), other weights N(0, 1/fan_in)."""
    import torch

    t = torch.empty(shape, device=device)
    if key.endswith(".bias"):
        t.normal_(0.0, 0.02, generator=gen)
    elif len(shape) == 1 or key.endswith(".gamma"):
        t.normal_(1.0, 0.02, generator=gen)
    elif key == "shared.weight":
        t.normal_(0.0, 1.0, generator=gen)
    elif "relative_attention_bias" in key:
        t.normal_(0.0, 0.1, generator=gen)
    else:
        t.normal_(0.0, math.prod(shape[1:]) ** -0.5, generator=gen)
    return t.to(torch.bfloat16)


def checkpoint_sample_keys(cfg):
    """Upstream keys the checkpoint check holds against the loaded modules:
    every kind of key of the three models (fused qkv, the conv patch
    embedding, norm scales, UMT5's relative-attention tables, VAE conv3d,
    resample conv2d and attention convs) at the first, a middle and the
    last block."""
    d, L, v = cfg.dit.depth, cfg.text.num_layers, cfg.vae
    keys = {"dit": ["x_embedder.proj.weight", "x_embedder.proj.bias",
                    "t_embedder.mlp.0.weight", "t_embedder.mlp.2.bias",
                    "y_embedder.y_proj.0.weight", "final_layer.adaLN_modulation.1.weight",
                    "final_layer.linear.weight", "final_layer.linear.bias"],
            "text_encoder": ["encoder.final_layer_norm.weight"], "vae": []}
    for i in sorted({0, d // 3, d - 1}):
        keys["dit"] += [f"blocks.{i}.{name}" for name in (
            "adaLN_modulation.1.weight", "attn.qkv.weight", "attn.qkv.bias",
            "attn.q_norm.weight", "attn.k_norm.weight", "cross_attn.q_linear.weight",
            "cross_attn.kv_linear.weight", "cross_attn.k_norm.weight",
            "pre_crs_attn_norm.weight", "pre_crs_attn_norm.bias", "ffn.w2.weight")]
    for i in sorted({0, L - 1}):
        a, f = f"encoder.block.{i}.layer.0.", f"encoder.block.{i}.layer.1."
        keys["text_encoder"] += [a + "SelfAttention.q.weight", a + "SelfAttention.o.weight",
                                 a + "SelfAttention.relative_attention_bias.weight",
                                 a + "layer_norm.weight", f + "DenseReluDense.wi_0.weight",
                                 f + "DenseReluDense.wo.weight", f + "layer_norm.weight"]
    nrb = v.num_res_blocks
    keys["vae"] += ["encoder.conv1.weight", "encoder.conv1.bias",
                    "encoder.downsamples.0.residual.0.gamma",
                    "encoder.downsamples.0.residual.2.weight",
                    f"encoder.downsamples.{nrb + 1}.shortcut.weight",
                    f"encoder.downsamples.{nrb}.resample.1.weight",
                    f"encoder.downsamples.{2 * nrb + 1}.time_conv.weight",
                    "encoder.middle.1.to_qkv.weight", "encoder.middle.1.to_qkv.bias",
                    "encoder.middle.1.proj.weight", "encoder.middle.2.residual.6.weight",
                    "encoder.head.0.gamma", "encoder.head.2.weight", "conv1.weight",
                    "conv2.weight", "decoder.conv1.weight", "decoder.middle.1.to_qkv.weight",
                    "decoder.upsamples.0.residual.3.gamma",
                    "decoder.upsamples.0.residual.6.weight",
                    f"decoder.upsamples.{nrb + 1}.resample.1.weight",
                    f"decoder.upsamples.{nrb + 1}.time_conv.weight",
                    "decoder.head.0.gamma", "decoder.head.2.weight"]
    return keys


_PORT_NAMES = {
    "dit": [(r"^x_embedder\.proj\.", "x_embed."), (r"^t_embedder\.mlp\.0\.", "t_embed.w1."),
            (r"^t_embedder\.mlp\.2\.", "t_embed.w2."), (r"^y_embedder\.y_proj\.0\.", "y_embed.in."),
            (r"^y_embedder\.y_proj\.2\.", "y_embed.out."),
            (r"^final_layer\.adaLN_modulation\.1\.", "final.adaln."),
            (r"^final_layer\.linear\.", "final.proj."), (r"adaLN_modulation\.1\.", "adaln."),
            (r"_norm\.weight$", "_norm"), (r"pre_crs_attn_norm", "pre_crs_norm"),
            (r"q_linear", "q"), (r"kv_linear", "kv"), (r"pre_crs_norm$", "pre_crs_norm.weight")],
    "text_encoder": [(r"^shared\.weight$", "embed"),
                     (r"^encoder\.final_layer_norm\.weight$", "final_ln"),
                     (r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.relative_attention_bias"
                      r"\.weight$", r"blocks.\1.rel_bias"),
                     (r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.", r"blocks.\1."),
                     (r"^encoder\.block\.(\d+)\.layer\.0\.layer_norm\.weight$", r"blocks.\1.ln1"),
                     (r"^encoder\.block\.(\d+)\.layer\.1\.layer_norm\.weight$", r"blocks.\1.ln2"),
                     (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.wi_0", r"blocks.\1.wi0"),
                     (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.wi_1", r"blocks.\1.wi1"),
                     (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.wo", r"blocks.\1.wo")],
}


def expected_port_tensors(component: str, key: str, value, vcfg):
    """[(port state-dict name, expected tensor)] of one upstream tensor
    after the transform the port applies, written out independently of
    the converter: torch layouts match the port's except the Conv3d patch
    embedding (flattened in patchify order), the VAE's flat module lists
    (mapped to scales), norm gammas (flattened), 1x1 attention convs (as
    matrices, to_qkv split in three) and the resample Conv2d (kt = 1)."""
    if component != "vae":
        name = key
        for pat, rep in _PORT_NAMES[component]:
            name = re.sub(pat, rep, name)
        if key == "x_embedder.proj.weight" and value.ndim == 5:
            value = value.permute(0, 2, 3, 4, 1).reshape(value.shape[0], -1)
        return [(name, value)]
    nrb, n_scales = vcfg.num_res_blocks, len(vcfg.dim_mults)
    parts = key.split(".")
    fixed = {"encoder.conv1": "enc.conv_in", "encoder.head.2": "enc.conv_out",
             "encoder.head.0": "enc.norm_out", "conv1": "enc.quant",
             "conv2": "dec.post_quant", "decoder.conv1": "dec.conv_in",
             "decoder.head.2": "dec.conv_out", "decoder.head.0": "dec.norm_out"}
    stem, leaf = ".".join(parts[:-1]), parts[-1]
    if stem in fixed:
        base = fixed[stem]
    elif parts[1] == "middle":
        side = "enc" if parts[0] == "encoder" else "dec"
        sub = {"0": "res1", "1": "attn", "2": "res2"}[parts[2]]
        base = f"{side}.mid.{sub}" + ("." + ".".join(parts[3:-1]) if len(parts) > 4 else "")
    else:
        side, k = ("enc", nrb + 1) if parts[0] == "encoder" else ("dec", nrb + 2)
        flat = int(parts[2])
        scale, j = divmod(flat, k)
        rest = ".".join(parts[3:-1])
        if j < k - 1:
            base = f"{side}.scales.{scale}.res.{j}." + rest
        else:
            assert side == "dec" or scale < n_scales - 1
            base = f"{side}.scales.{scale}." + {
                "resample.1": "sdown" if side == "enc" else "sup",
                "time_conv": "tdown" if side == "enc" else "tup"}[rest]
    for up, port in (("residual.0", "norm1"), ("residual.2", "conv1"), ("residual.3", "norm2"),
                     ("residual.6", "conv2")):
        base = base.replace(up, port)
    if leaf == "gamma":
        return [(base + ".weight", value.reshape(-1))]
    if base.endswith("attn.to_qkv"):
        c = value.shape[0] // 3
        return [(base.replace("to_qkv", n) + "." + leaf,
                 value[i * c:(i + 1) * c].reshape(c, -1) if leaf == "weight"
                 else value[i * c:(i + 1) * c]) for i, n in enumerate("qkv")]
    if base.endswith("attn.proj") and leaf == "weight":
        return [(base + ".weight", value.reshape(value.shape[0], -1))]
    if value.ndim == 4:  # the resample Conv2d as a kt = 1 Conv3d
        value = value[:, :, None]
    return [(base + "." + leaf, value)]


def check_loaded(bundle, kept, vae_cfg) -> int:
    """Hold each loaded tensor of the drawn sample ``kept`` against its
    shard value after the transform; returns how many were equal (raises
    on the first that is not)."""
    import torch

    mods = {"dit": bundle.dit, "vae": bundle.vae, "text_encoder": bundle.text}
    checked = 0
    for component, drawn in kept.items():
        params = mods[component].state_dict()
        for key, value in drawn.items():
            for name, want in expected_port_tensors(component, key, value, vae_cfg):
                got = params[name]
                if not torch.equal(got, want.to(got.dtype)):
                    raise AssertionError(f"{component} {key} -> {name}: loaded tensor "
                                         f"differs from the shard value")
                checked += 1
    return checked


def write_checkpoint(folder: str, cfg, seed: int, sample=None, device="cuda",
                     shapes=None):
    """A LongCat-layout checkpoint of ``cfg`` (dit/, vae/, text_encoder/
    as bf16 safetensors shards of at most CKPT["shard_bytes"]; no
    tokenizer folder; ``shapes``: another layout's table, e.g.
    ``MMDIT_STATE_SHAPES``) drawn on the card from ``seed``. Returns (bytes
    written, {component: {key: drawn tensor}} for the keys of
    ``sample``)."""
    import torch

    from longcat_video_tta_tpu_torch.models.convert import STATE_SHAPES
    from longcat_video_tta_tpu_torch.utils.safetensors import save_file

    gen = torch.Generator(device=device).manual_seed(seed)
    total, kept = 0, {}
    for component, shapes_of in (shapes or STATE_SHAPES).items():
        os.makedirs(os.path.join(folder, component))
        want, kept[component] = set((sample or {}).get(component, ())), {}
        shard, size, n = {}, 0, 0

        def flush():
            nonlocal shard, size, n
            save_file(shard, os.path.join(folder, component, f"model-{n:05d}.safetensors"))
            n, shard, size = n + 1, {}, 0

        for key, shape in shapes_of(cfg).items():
            nbytes = 2 * math.prod(shape)
            if shard and size + nbytes > CKPT["shard_bytes"]:
                flush()
            shard[key] = synth_value(key, shape, gen, device)
            if key in want:
                kept[component][key] = shard[key].clone()
            size += nbytes
            total += nbytes
        flush()
        missing = want - set(kept[component])
        if missing:
            raise AssertionError(f"sample keys not in the {component} layout: {missing}")
    return total, kept


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class PeakRSS:
    """The largest resident set size of this process while the block
    runs, sampled every CKPT["rss_every_s"] seconds by a thread."""

    def __enter__(self):
        import threading

        self.base = self.peak = _rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(CKPT["rss_every_s"]):
                self.peak = max(self.peak, _rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())
        return False


def phase_checkpoint_path(fa):
    """A LongCat-13.6B-layout checkpoint (the preset's blocks: 12 of 48
    under ``at_cut_depth``, as chip_smoke runs it; UMT5-XXL, WAN VAE base
    96; bf16 shards of at most 5 GB) written under a temporary folder and
    loaded through the runner's --checkpoint-dir: load time, rate and the
    host's peak RSS; sampled tensors against their drawn values; one
    serving request on the loaded weights. Then the same kind of folder at
    longcat_demo widths loaded on the card and on the CPU: generate_vc must
    agree."""
    import tempfile

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import get_model_config
    from longcat_video_tta_tpu_torch.runners import run_tta

    cfg = get_model_config("longcat_13b")
    folder = tempfile.mkdtemp(prefix="ckpt-", dir=RUN_DIR)
    try:
        sample = checkpoint_sample_keys(cfg)
        n_sample = sum(len(v) for v in sample.values())
        t0 = time.time()
        nbytes, kept = write_checkpoint(folder, cfg, CKPT["seed"], sample)
        t_write = time.time() - t0
        shards = {c: sorted(os.listdir(os.path.join(folder, c))) for c in kept}
        print(f"[ckpt] wrote {nbytes / 1e9:.2f} GB of bf16 shards in {t_write:.1f} s "
              f"({ {c: len(s) for c, s in shards.items()} } shards, at most "
              f"{CKPT['shard_bytes'] / 1e9:.0f} GB each) under {folder}")
        base = ["--preset", "longcat_13b", "--device", "cuda", "--checkpoint-dir", folder]
        args = run_tta.build_arg_parser().parse_args(
            base + ["--output-dir", os.path.join(RUN_DIR, "ckpt_run")])
        torch.cuda.synchronize()
        with PeakRSS() as rss:
            t0 = time.time()
            bundle = run_tta.load_bundle(args)
            torch.cuda.synchronize()
            t_load = time.time() - t0
        print(f"[ckpt] load through --checkpoint-dir: {t_load:.2f} s, "
              f"{nbytes / t_load / 1e9:.2f} GB/s; host RSS peak {rss.peak / 2**30:.2f} GiB "
              f"(before the load {rss.base / 2**30:.2f} GiB, +{(rss.peak - rss.base) / 2**30:.2f}"
              f" GiB); card memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        checked = check_loaded(bundle, kept, cfg.vae)
        print(f"[ckpt] {checked} loaded tensors of {n_sample} sampled upstream keys equal "
              f"their shard values after the transform")
        if checked < 64:
            raise AssertionError(f"only {checked} tensors checked")
        del bundle, kept
        torch.cuda.empty_cache()

        out_dir = os.path.join(RUN_DIR, "ckpt_run")
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = ["--method", "none", *base, "--synthetic", "1", "--output-dir", out_dir,
                "--height", str(MAIN["height"]), "--width", str(MAIN["width"]),
                "--num-cond-frames", str(MAIN["cond_frames"]),
                "--num-frames", str(MAIN["gen_frames"]),
                "--num-inference-steps", str(MAIN["steps"]),
                "--guidance-scale", str(MAIN["guidance"]), "--no-save-videos",
                "--caption-guard-mode", "off"]
        print("[ckpt] run_tta " + " ".join(argv))
        fa.reset_launches()
        t0 = time.time()
        summary = run_tta.main(argv)
        wall = time.time() - t0
        launches = fa.launches
        r = summary["results"][0]
        expected = cfg.dit.depth * 2 * (1 + MAIN["steps"])
        print(f"[ckpt] request on the loaded weights: success={r['success']} "
              f"gen_time={r.get('gen_time')} s psnr={r.get('psnr')} ssim={r.get('ssim')}; "
              f"wall {wall:.1f} s with the load; flash_fwd launches {launches} "
              f"(expected {expected}, as [main] per request)"
              + (f" error={r['error']}" if "error" in r else ""))
        if not (r["success"] and np.isfinite([r["psnr"], r["ssim"]]).all()):
            raise AssertionError(f"request on the checkpoint's weights failed: {r}")
        if launches != expected:
            raise AssertionError(f"flash_fwd launches {launches}, expected {expected}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
        shutil.rmtree(os.path.join(RUN_DIR, "ckpt_run"), ignore_errors=True)
    phase_checkpoint_agreement()
    return launches


def phase_checkpoint_agreement():
    """A longcat_demo-width LongCat-layout folder loaded on the card and
    on the CPU (``ModelBundle.from_checkpoint_dir``): generate_vc on the
    same conditioning and noise must agree."""
    import tempfile

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import longcat_demo
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc

    folder = tempfile.mkdtemp(prefix="ckpt-demo-", dir=RUN_DIR)
    try:
        write_checkpoint(folder, longcat_demo(), CKPT["seed"] + 1)
        cpu = ModelBundle.from_checkpoint_dir(longcat_demo(), folder, "cpu")
        gpu = ModelBundle.from_checkpoint_dir(longcat_demo(), folder, "cuda")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rng = np.random.default_rng(5)
    cond = rng.uniform(-1, 1, (1, 3, 5, 64, 128)).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 2, 8, 16)).astype(np.float32))
    kw = dict(num_frames=5, num_inference_steps=2, init_noise=noise)
    a = generate_vc(cpu, cond, "a ball moving across the scene", **kw)
    b = generate_vc(gpu, cond, "a ball moving across the scene", **kw)
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    psnr = float("inf") if mse == 0 else -10 * math.log10(mse)
    print(f"[ckpt] longcat_demo checkpoint generate_vc card vs cpu: shape {b.shape}, "
          f"max|diff| {float(np.abs(a - b).max()):.4g}, psnr {psnr:.2f} dB "
          f"(min {E2E_PSNR_MIN})")
    if not (np.isfinite(b).all() and psnr >= E2E_PSNR_MIN):
        raise AssertionError("card and CPU generate_vc on the loaded checkpoint disagree")


# ---------------------------------------------------------------------------
# Remat path: delta_a on longcat_bench under the three policies
# ---------------------------------------------------------------------------

REMAT = dict(steps=3, seed=21, loss_rtol=1e-3, grad_cos_min=0.9999)


def _window_inputs(dit_cfg, n_train_lat, seed, *, pad_to=None, pad_value=None):
    """Seeded delta_a inputs on the card at the delta_a window (480x832:
    cond and train latents of 60 x 104, the text at full length), the
    train latents and the noise optionally padded to ``pad_to`` latents
    with ``pad_value``."""
    import torch

    n_cond_lat = tta_split()[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = lambda t: torch.randn((1, dit_cfg.in_channels, t, 60, 104), generator=g,
                                device="cuda")
    out = dict(cond=lat(n_cond_lat), train=lat(n_train_lat), noise=lat(n_train_lat),
               emb=torch.randn((1, dit_cfg.text_len, dit_cfg.text_dim), generator=g,
                               device="cuda").to(torch.bfloat16),
               mask=torch.ones((1, dit_cfg.text_len), dtype=torch.int64, device="cuda"),
               sigma=torch.tensor([0.6], device="cuda"))
    if pad_to is not None:
        for k in ("train", "noise"):
            pad = torch.full(out[k].shape[:2] + (pad_to - n_train_lat,) + out[k].shape[3:],
                             pad_value, device="cuda")
            out[k] = torch.cat([out[k], pad], dim=2)
    return out


def _loss_grad(dit, x, num_valid_target=None):
    """Loss and d(loss)/d(delta_t) of one delta_a step at delta_t = 0.01."""
    import torch

    from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

    delta = torch.full((dit.cfg.adaln_tembed_dim,), 0.01, device="cuda",
                       requires_grad=True)
    loss = flow_matching_loss_conditioned(
        dit, x["cond"], x["train"], x["emb"], x["mask"], adapters={"delta_t": delta},
        sigma=x["sigma"], noise=x["noise"], num_valid_target=num_valid_target)
    (grad,) = torch.autograd.grad(loss, [delta])
    return float(loss.detach()), grad.double()


def _agree_gate(tag, loss, grad, loss_ref, grad_ref, rtol, cos_min):
    rel = abs(loss - loss_ref) / abs(loss_ref)
    cos = float((grad @ grad_ref) / (grad.norm() * grad_ref.norm()))
    print(f"[{tag}] loss {loss:.7g} vs {loss_ref:.7g} (rel {rel:.3g}, max {rtol}); "
          f"grad cosine {cos:.7f} (min {cos_min})")
    if not (rel <= rtol and cos >= cos_min):
        raise AssertionError(f"{tag}: loss or gradient disagrees")


def random_dit(cfg, seed: int):
    """A DiT of ``cfg`` with random weights drawn on the card."""
    import torch

    from longcat_video_tta_tpu_torch.models.weights import init_random_dit

    return init_random_dit(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))


def phase_remat_path(fa):
    """delta_a on longcat_bench (hidden 2048, 16 blocks, 16 heads of 128) at
    the delta_a window under full, dots and dots_attn: per policy the
    train-step time, peak memory and launches per step against
    ``train_step_launches``, the loss and gradient on the same injected
    draws against full's; then the runner trains longcat_bench under its
    own default policy (dots_attn); then the bytes dots_attn saves per
    block at LongCat-13.6B width (a DiT cut to 2 blocks), extrapolated to
    48 blocks."""
    import dataclasses

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import AdapterConfig, OptimConfig, \
        get_model_config
    from longcat_video_tta_tpu_torch.runners import run_tta
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
    from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_step

    cfg = get_model_config("longcat_bench")
    dit = random_dit(cfg.dit, REMAT["seed"])
    x = _window_inputs(cfg.dit, tta_split()[1], REMAT["seed"] + 1)
    scheme = build_scheme(cfg.dit, AdapterConfig(method="delta_a"))
    opt = build_optimizer(OptimConfig(lr=1e-3, steps=REMAT["steps"]))
    per_policy, ref = {}, None
    for policy in ("full", "dots", "dots_attn"):
        dit.cfg = dataclasses.replace(cfg.dit, remat_policy=policy)
        loss, grad = _loss_grad(dit, x)
        if ref is None:
            ref = (loss, grad)
        else:
            _agree_gate(f"remat {policy} vs full", loss, grad, *ref,
                        REMAT["loss_rtol"], REMAT["grad_cos_min"])
        tp = scheme.init("cuda", dit=dit, generator=torch.Generator(device="cuda"))
        state = opt.init(tp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        times, counts = [], []
        for _ in range(REMAT["steps"]):
            fa.reset_launches()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            tp, state, _ = train_step(scheme, dit, opt, tp, state, x["cond"], x["train"],
                                      x["emb"], x["mask"], sigma=x["sigma"],
                                      noise=x["noise"])
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
            counts.append({"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
                           "flash_bwd_dkv": fa.bwd_dkv_launches})
        expected = train_step_launches("t_embed", cfg.dit.depth, policy)
        peak = torch.cuda.max_memory_allocated()
        per_policy[policy] = dict(step_s=times, peak_gib=peak / 2**30,
                                  above_weights_gib=(peak - base_mem) / 2**30,
                                  launches_per_step=counts[-1])
        print(f"[remat] longcat_bench {policy}: train step {times} s; peak "
              f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB above the "
              f"weights); launches per step {counts[-1]} (expected {expected})")
        if any(c != expected for c in counts):
            raise AssertionError(f"remat {policy}: launches per step {counts}, "
                                 f"expected {expected}")
    del dit
    torch.cuda.empty_cache()

    # the runner trains longcat_bench under its default policy
    out_dir = os.path.join(RUN_DIR, "remat_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--method", "delta_a", "--preset", "longcat_bench", "--synthetic", "1",
            "--output-dir", out_dir, "--device", "cuda",
            "--height", str(METHOD["height"]), "--width", str(METHOD["width"]),
            "--num-cond-frames", str(METHOD["cond_frames"]),
            "--tta-total-frames", str(METHOD["tta_total_frames"]),
            "--num-frames", str(METHOD["gen_frames"]), "--steps", str(METHOD["steps"]),
            "--es-check-every", str(METHOD["check_every"]),
            "--num-inference-steps", str(METHOD["inference_steps"]),
            "--guidance-scale", str(METHOD["guidance"]), "--no-save-videos",
            "--caption-guard-mode", "off"]
    print("[remat] run_tta " + " ".join(argv))
    expected = method_launches("t_embed", cfg.dit.depth, steps=METHOD["steps"],
                               anchors=1 + METHOD["steps"] // METHOD["check_every"],
                               inference_steps=METHOD["inference_steps"],
                               policy=cfg.dit.remat_policy)
    fa.reset_launches()
    summary = run_tta.main(argv)
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    r = summary["results"][0]
    anchors = [loss for _, loss in (r.get("early_stopping_info") or {}).get(
        "loss_history", [])]
    print(f"[remat] longcat_bench under its default policy "
          f"({cfg.dit.remat_policy}): success={r['success']} train_time="
          f"{r.get('train_time')} s losses={r.get('losses')} anchors={anchors} "
          f"psnr={r.get('psnr')}; launches {got} (expected {expected})"
          + (f" error={r['error']}" if "error" in r else ""))
    if not (r["success"] and np.isfinite(r["losses"] + anchors).all()
            and len(anchors) == 2 and anchors[0] != anchors[1]):
        raise AssertionError(f"longcat_bench did not train under dots_attn: {r}")
    if got != expected:
        raise AssertionError(f"longcat_bench runner launches {got}, expected {expected}")
    shutil.rmtree(out_dir, ignore_errors=True)

    # what each policy keeps per block at LongCat-13.6B width
    big = get_model_config("longcat_13b").dit
    cut = dataclasses.replace(big, depth=2)
    dit = random_dit(cut, REMAT["seed"] + 2)
    x = _window_inputs(cut, tta_split()[1], REMAT["seed"] + 3)
    kept = {}
    for policy in ("full", "dots", "dots_attn"):
        from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

        dit.cfg = dataclasses.replace(cut, remat_policy=policy)
        delta = torch.zeros((cut.adaln_tembed_dim,), device="cuda", requires_grad=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = flow_matching_loss_conditioned(
            dit, x["cond"], x["train"], x["emb"], x["mask"], adapters={"delta_t": delta},
            sigma=x["sigma"], noise=x["noise"])
        torch.cuda.synchronize()
        kept[policy] = (torch.cuda.memory_allocated() - before) / cut.depth
        del loss, delta
    tokens = sum(tta_split()[:2]) * (MAIN["height"] // 16) * (MAIN["width"] // 16)
    weights_gib = 36.0
    extra = {p: big.depth * (kept[p] - kept["full"]) / 2**30 for p in kept}
    print(f"[remat] LongCat-13.6B width, delta_a window ({tokens} tokens), bytes kept "
          f"per block by the forward: " + ", ".join(
              f"{p} {kept[p] / 2**20:.1f} MiB ({kept[p] / tokens / 1e3:.1f} KB per token)"
              for p in kept)
          + f"; over 48 blocks beyond full's: dots {extra['dots']:.1f} GiB, dots_attn "
          f"{extra['dots_attn']:.1f} GiB beside about {weights_gib:.0f} GiB of weights "
          f"on an 80 GB card")
    del dit, x
    torch.cuda.empty_cache()
    return per_policy, got


# ---------------------------------------------------------------------------
# Bucket path: delta_a at 13.6B with --bucket-shapes and augmentation
# ---------------------------------------------------------------------------

BUCKET = dict(seed=31, pad_value=1e3, loss_rtol=1e-3, grad_cos_min=0.9999)


def phase_bucket_path(fa):
    """A bucketed delta_a train step at LongCat-13.6B width and depth (the
    3-latent target padded to 4 with large values) against the same step
    unpadded on the same valid noise and sigma; then the runner on 1 video
    with --bucket-shapes --aug-enabled --aug-hflip --aug-speed-factors 2
    --save-adapters: its launches against ``method_launches`` and the
    saved adapter loaded back."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import get_model_config
    from longcat_video_tta_tpu_torch.runners import run_tta
    from longcat_video_tta_tpu_torch.tta.bucket import bucket_len
    from longcat_video_tta_tpu_torch.tta.engine import global_norm
    from longcat_video_tta_tpu_torch.utils.checkpoint import load_adapter_state

    cfg = get_model_config("longcat_13b")
    n_train = tta_split()[1]
    n_pad = bucket_len(n_train)
    dit = random_dit(cfg.dit, BUCKET["seed"])
    plain = _window_inputs(cfg.dit, n_train, BUCKET["seed"] + 1)
    padded = _window_inputs(cfg.dit, n_train, BUCKET["seed"] + 1, pad_to=n_pad,
                            pad_value=BUCKET["pad_value"])
    loss_ref, grad_ref = _loss_grad(dit, plain)
    fa.reset_launches()
    loss, grad = _loss_grad(dit, padded, num_valid_target=n_train)
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    tpf = (MAIN["height"] // 16) * (MAIN["width"] // 16)
    print(f"[bucket] train step with the target padded {n_train} -> {n_pad} latents "
          f"(Sq = Sk = {(tta_split()[0] + n_pad) * tpf}, kv_valid "
          f"{(tta_split()[0] + n_train) * tpf}; pad filled with {BUCKET['pad_value']}) vs "
          f"unpadded; launches {got}")
    _agree_gate("bucket padded vs unpadded", loss, grad, loss_ref, grad_ref,
                BUCKET["loss_rtol"], BUCKET["grad_cos_min"])
    if got != train_step_launches("t_embed", cfg.dit.depth):
        raise AssertionError(f"bucketed step launches {got}")
    del dit, plain, padded
    torch.cuda.empty_cache()

    out_dir = os.path.join(RUN_DIR, "bucket_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--method", "delta_a", "--preset", "longcat_13b", "--synthetic", "1",
            "--output-dir", out_dir, "--device", "cuda",
            "--height", str(METHOD["height"]), "--width", str(METHOD["width"]),
            "--num-cond-frames", str(METHOD["cond_frames"]),
            "--tta-total-frames", str(METHOD["tta_total_frames"]),
            "--num-frames", str(METHOD["gen_frames"]), "--steps", str(METHOD["steps"]),
            "--es-check-every", str(METHOD["check_every"]),
            "--num-inference-steps", str(METHOD["inference_steps"]),
            "--guidance-scale", str(METHOD["guidance"]), "--no-save-videos",
            "--caption-guard-mode", "off", "--bucket-shapes", "--aug-enabled",
            "--aug-hflip", "--aug-speed-factors", "2", "--save-adapters"]
    print("[bucket] run_tta " + " ".join(argv))
    expected = method_launches("t_embed", cfg.dit.depth, steps=METHOD["steps"],
                               anchors=1 + METHOD["steps"] // METHOD["check_every"],
                               inference_steps=METHOD["inference_steps"])
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.time()
    summary = run_tta.main(argv)
    wall = time.time() - t0
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    r = summary["results"][0]
    anchors = [loss for _, loss in (r.get("early_stopping_info") or {}).get(
        "loss_history", [])]
    print(f"[bucket] success={r['success']} train_time={r.get('train_time')} s "
          f"es_check_time={r.get('es_check_time')} s gen_time={r.get('gen_time')} s "
          f"losses={r.get('losses')} anchors={anchors} adapter_norm={r.get('adapter_norm')} "
          f"psnr={r.get('psnr')} ssim={r.get('ssim')} adapter_path={r.get('adapter_path')}; "
          f"wall {wall:.1f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got} "
          f"(expected {expected})" + (f" error={r['error']}" if "error" in r else ""))
    if not (r["success"] and np.isfinite(r["losses"] + anchors + [r["psnr"]]).all()
            and len(anchors) == 2 and anchors[0] != anchors[1]):
        raise AssertionError(f"bucketed delta_a run failed or did not train: {r}")
    if got != expected:
        raise AssertionError(f"bucketed delta_a launches {got}, expected {expected}")
    saved = load_adapter_state(r["adapter_path"], "cuda")
    shapes = {k: tuple(v.shape) for k, v in saved.items()}
    # delta_a trains one vector of the t-embedding's width; its norm is the
    # run's adapter_norm, computed on the same tensor before it was saved
    if (list(shapes.values()) != [(cfg.dit.adaln_tembed_dim,)]
            or float(global_norm(saved)) != r["adapter_norm"]):
        raise AssertionError(f"the saved adapter does not load back: {shapes}, norm "
                             f"{float(global_norm(saved))} vs {r['adapter_norm']}")
    print(f"[bucket] adapter {r['adapter_path']} loads back: {shapes}, norm "
          f"{float(global_norm(saved))} (the run's adapter_norm {r['adapter_norm']})")
    shutil.rmtree(out_dir, ignore_errors=True)
    return got


# ---------------------------------------------------------------------------
# [eval]: the CLIP gate and the evaluation towers at their published
# geometries, card against CPU, then the runner gated and scored at 13.6B
# ---------------------------------------------------------------------------

# openai/clip-vit-base-patch32 and microsoft/xclip-base-patch32
EVAL = dict(seed=41, frames=16, clip_frames=4, lpips_pairs=8, height=480, width=832,
            cos_min=0.99999, rel_max=1e-4, gate_steps=3, check_every=3,
            inference_steps=4, videos=2)


def _agreement(tag: str, card, cpu) -> dict:
    """cosine and relative L2 error of a card result against the CPU's."""
    import torch

    a, b = card.detach().double().cpu().flatten(), cpu.detach().double().flatten()
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
    rel = float((a - b).norm() / b.norm())
    ok = cos >= EVAL["cos_min"] and rel <= EVAL["rel_max"]
    print(f"[eval] {tag}: cosine {cos:.8f} rel_l2 {rel:.3e} "
          f"max_abs {float((a - b).abs().max()):.3e} ({'ok' if ok else 'FAILED'})")
    if not ok:
        raise AssertionError(f"[eval] {tag}: card vs CPU cosine {cos} rel {rel} (gates "
                             f"{EVAL['cos_min']}, {EVAL['rel_max']})")
    return {"cos": cos, "rel": rel}


def phase_eval_towers(paths: dict, smi: str, card: str = "cuda") -> dict:
    """(b): each tower converted on the card and on the CPU from the same
    file, fed the same inputs; the card's time per call (CUDA events,
    after a warm-up)."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import (CLIPTextConfig, CLIPVisionConfig,
                                                    XCLIPConfig)
    from longcat_video_tta_tpu_torch.eval import i3d, inception, lpips
    from longcat_video_tta_tpu_torch.models import clip, convert, xclip
    from longcat_video_tta_tpu_torch.tta.clip_gate import make_clip_scorer
    from longcat_video_tta_tpu_torch.utils.device import full_fp32

    rng = np.random.default_rng(EVAL["seed"])
    H, W, n = EVAL["height"], EVAL["width"], EVAL["clip_frames"]
    frames = rng.random((8, H, W, 3), dtype=np.float32)
    gt = np.clip(frames + 0.1 * rng.standard_normal(frames.shape, dtype=np.float32), 0, 1)
    caption = "a ball moving across the scene"
    g = CLIP_GEOMETRY
    devices = (card, "cpu")
    out = {}
    on_card = lambda t: t.to(card)

    # CLIP: image embeds of 4 frames, text embeds of the hash-tokenized caption
    tcfg = CLIPTextConfig(vocab_size=g["vocab"], width=g["text_width"],
                          num_layers=g["text_layers"], num_heads=g["text_heads"],
                          max_length=g["max_len"])
    vcfg = CLIPVisionConfig(width=g["vision_width"], num_layers=g["vision_layers"],
                            num_heads=g["vision_heads"], patch_size=g["patch"],
                            image_size=g["image"], projection_dim=g["proj"])
    ids = torch.as_tensor(clip.clip_hash_tokenize(caption, g["max_len"], g["vocab"]),
                          dtype=torch.long)[None]
    sd, _ = convert.read_hf_clip_dir(paths["clip"])
    res = {}
    for dev in devices:
        m = convert.convert_torch_clip_model_state(sd, vcfg, tcfg, dev)
        with torch.no_grad(), full_fp32():
            px = clip.preprocess_frames(frames[:n], g["image"], dev)
            res[dev] = (m, px, m.image_embed(px), m.text_embed(ids.to(dev)))
    _agreement(f"clip preprocess {n}x{H}x{W} -> {g['image']}", res[card][1], res["cpu"][1])
    out["clip_image"] = _agreement("clip image embeds", res[card][2], res["cpu"][2])
    out["clip_text"] = _agreement("clip text embeds", res[card][3], res["cpu"][3])
    m, px = res[card][:2]
    with torch.no_grad(), full_fp32():
        ms_img = _events_ms(lambda: m.image_embed(px), 10)
        ms_txt = _events_ms(lambda: m.text_embed(on_card(ids)), 10)
    del res, m, px
    gate = make_clip_scorer(paths["clip"], "clip", card, allow_hash_tokenizer=True)
    out["clip_ms"] = _events_ms(lambda: gate(frames[:n], caption), 5)
    print(f"[eval] {smi}: clip image tower {ms_img:.3f} ms per call ({n} frames), text "
          f"tower {ms_txt:.3f} ms, the gate's scorer end to end (preprocess, both towers, "
          f"host copy) {out['clip_ms']:.3f} ms")
    del gate
    # X-CLIP: the video score of 8 frames
    sd, _ = convert.read_hf_clip_dir(paths["xclip"])
    xcfg = XCLIPConfig(vision=vcfg, text=tcfg, num_frames=g["frames"],
                       mit_layers=g["mit_layers"], mit_heads=g["mit_heads"],
                       prompt_layers=g["prompt_layers"], prompt_heads=g["prompt_heads"])
    xs = {}
    for dev in devices:
        m = convert.convert_torch_xclip_state(sd, xcfg, dev)
        px = clip.preprocess_frames(frames, g["image"], dev)[None]
        xs[dev] = (m, px, xclip.xclip_scores(m, px, ids.to(dev)))
    out["xclip"] = _agreement(f"xclip score 8x{H}x{W}", xs[card][2], xs["cpu"][2])
    m, px, score = xs[card]
    out["xclip_ms"] = _events_ms(lambda: xclip.xclip_scores(m, px, on_card(ids)), 5)
    print(f"[eval] {smi}: xclip tower {out['xclip_ms']:.3f} ms per call (8 frames); "
          f"score {float(score):.6f}")
    del xs, m, px, sd
    # LPIPS on 8 frame pairs
    lp = {dev: lpips.load_lpips_params(paths["lpips"], dev) for dev in devices}
    d = {dev: lpips.lpips_alex(m, frames, gt) for dev, m in lp.items()}
    out["lpips"] = _agreement(f"lpips 8 pairs {H}x{W}", d[card], d["cpu"])
    fc, gc = on_card(torch.from_numpy(frames)), on_card(torch.from_numpy(gt))
    out["lpips_ms"] = _events_ms(lambda: lpips.lpips_alex(lp[card], fc, gc), 5)
    print(f"[eval] {smi}: lpips tower {out['lpips_ms']:.3f} ms per call (8 pairs)")
    # I3D on one 16 x 224 x 224 clip in [-1, 1]
    clip16 = rng.random((1, EVAL["frames"], 224, 224, 3), dtype=np.float32) * 2 - 1
    m3 = {dev: i3d.load_i3d_params(paths["i3d"], dev) for dev in devices}
    z = {dev: i3d.i3d_logits(m, clip16) for dev, m in m3.items()}
    out["i3d"] = _agreement(f"i3d logits {EVAL['frames']}x224x224", z[card], z["cpu"])
    xc = on_card(torch.from_numpy(clip16))
    out["i3d_ms"] = _events_ms(lambda: i3d.i3d_logits(m3[card], xc), 5)
    print(f"[eval] {smi}: i3d tower {out['i3d_ms']:.3f} ms per call (1 clip of "
          f"{EVAL['frames']} frames)")
    # InceptionV3 on 16 frames at 299
    pre = inception.preprocess_frames(np.concatenate([frames, gt])[:EVAL["frames"]])
    mi = {dev: inception.load_inception_params(paths["inception"], dev) for dev in devices}
    f = {dev: inception.inception_features(m, pre) for dev, m in mi.items()}
    out["inception"] = _agreement(f"inception features {EVAL['frames']}x299x299", f[card],
                                  f["cpu"])
    pc = on_card(torch.from_numpy(pre))
    out["inception_ms"] = _events_ms(lambda: inception.inception_features(mi[card], pc), 5)
    print(f"[eval] {smi}: inception tower {out['inception_ms']:.3f} ms per call "
          f"({EVAL['frames']} frames)")
    return out


def phase_eval_runs(fa, paths: dict, depth: int, card: str = "cuda",
                    preset: str = "longcat_13b"):
    """(c): the runner at LongCat-13.6B width and depth, gated and scored
    (delta_a, 2 videos, log-only CLIP gate, LPIPS, online FVD and FID),
    then one video that the X-CLIP gate skips (threshold 2.0)."""
    import numpy as np

    from longcat_video_tta_tpu_torch.runners import run_tta

    base = ["--method", "delta_a", "--preset", preset, "--device", card,
            "--height", str(TTA["height"]), "--width", str(TTA["width"]),
            "--num-cond-frames", str(TTA["cond_frames"]),
            "--tta-total-frames", str(TTA["tta_total_frames"]),
            "--num-frames", str(TTA["gen_frames"]), "--steps", str(EVAL["gate_steps"]),
            "--es-check-every", str(EVAL["check_every"]),
            "--es-patience", str(TTA["patience"]),
            "--num-inference-steps", str(EVAL["inference_steps"]),
            "--guidance-scale", str(TTA["guidance"]), "--no-save-videos"]
    runs = {
        "gated": ["--synthetic", str(EVAL["videos"]), "--clip-gate-enabled",
                  "--clip-gate-model-path", paths["clip"], "--clip-gate-hash-tokenizer",
                  "--clip-gate-log-only", "--lpips-model-path", paths["lpips"],
                  "--fvd-enabled", "--i3d-model-path", paths["i3d"],
                  "--inception-model-path", paths["inception"],
                  "--min-fvd-videos", str(EVAL["videos"])],
        "skip": ["--synthetic", "1", "--caption-guard-mode", "off", "--clip-gate-enabled",
                 "--clip-gate-backend", "xclip", "--clip-gate-model-path", paths["xclip"],
                 "--clip-gate-hash-tokenizer", "--clip-gate-threshold", "2.0"],
    }
    per_video = method_launches("t_embed", depth, steps=EVAL["gate_steps"],
                                anchors=1 + EVAL["gate_steps"] // EVAL["check_every"],
                                inference_steps=EVAL["inference_steps"])
    generation = method_launches("t_embed", depth, steps=0, anchors=0,
                                 inference_steps=EVAL["inference_steps"])
    expected = {"gated": {k: EVAL["videos"] * n for k, n in per_video.items()},
                "skip": generation}
    print(f"[eval] runner cuts: {EVAL['gate_steps']} TTA steps, check every "
          f"{EVAL['check_every']}, {EVAL['inference_steps']} denoising steps, "
          f"{TTA['gen_frames']} generated frames; full width and depth {depth}")
    total = {}
    for name, flags in runs.items():
        out_dir = os.path.join(RUN_DIR, f"eval_{name}")
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = base + ["--output-dir", out_dir] + flags
        print(f"[eval {name}] run_tta " + " ".join(argv))
        fa.reset_launches()
        t0 = time.time()
        summary = run_tta.main(argv)
        wall = time.time() - t0
        got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
               "flash_bwd_dkv": fa.bwd_dkv_launches}
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        for i, r in enumerate(summary["results"]):
            print(f"[eval {name}] video {i}: success={r['success']} "
                  f"skip_tta={r.get('skip_tta')} clip_gate_score={r.get('clip_gate_score')} "
                  f"clip_gate_eval_time={r.get('clip_gate_eval_time')} s "
                  f"train_time={r.get('train_time')} s gen_time={r.get('gen_time')} s "
                  f"total_time={r.get('total_time')} s psnr={r.get('psnr')} "
                  f"ssim={r.get('ssim')} lpips={r.get('lpips')} losses={r.get('losses')}"
                  + (f" error={r['error']}" if "error" in r else ""))
        print(f"[eval {name}] wall {wall:.1f} s; online_eval {summary['online_eval']}; "
              f"clip_gate_stats {summary['clip_gate_stats']}; launches {got} "
              f"(expected {expected[name]})")
        results = summary["results"]
        if summary["num_success"] != len(results) or not results:
            raise AssertionError(f"[eval {name}] a video failed: {results}")
        if name == "gated":
            state = np.load(os.path.join(out_dir, "fvd_state.npz"))
            oe, gs = summary["online_eval"], summary["clip_gate_stats"]
            finite = all(np.isfinite([r["clip_gate_score"], r["clip_gate_eval_time"],
                                      r["lpips"]]).all() for r in results)
            if not (finite and oe["num_videos"] == EVAL["videos"]
                    and np.isfinite([oe["fvd"], oe["fid"]]).all()
                    and gs["num_evaluated"] == EVAL["videos"]
                    and int(state["next_idx"]) == EVAL["videos"]):
                raise AssertionError(f"[eval gated] out of bounds: online_eval {oe}, "
                                     f"gate {gs}, next_idx {int(state['next_idx'])}")
        else:
            r = results[0]
            if not (r["skip_tta"] and r["train_time"] == 0 and "losses" not in r):
                raise AssertionError(f"[eval skip] the gate did not skip TTA: {r}")
        if got != expected[name]:
            raise AssertionError(f"[eval {name}] launches {got}, expected {expected[name]}")
        shutil.rmtree(out_dir, ignore_errors=True)
    return total


def phase_eval(fa, depth: int, smi: str, card: str = "cuda", preset: str = "longcat_13b"):
    import torch

    folder = os.path.join(RUN_DIR, "towers")
    shutil.rmtree(folder, ignore_errors=True)
    t0 = time.time()
    paths = write_tower_files(folder, EVAL["seed"], card)
    sizes = {k: sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(p)
                    for f in fs) if os.path.isdir(p) else os.path.getsize(p)
             for k, p in paths.items()}
    print(f"[eval] tower files drawn on the card and written in {time.time() - t0:.1f} s: "
          + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items()))
    towers = phase_eval_towers(paths, smi, card)
    torch.cuda.empty_cache()
    launches = phase_eval_runs(fa, paths, depth, card, preset)
    shutil.rmtree(folder, ignore_errors=True)
    return towers, launches


# ---------------------------------------------------------------------------
# Open-Sora v2 MMDiT path: the opensora_v2 preset (11.8B MMDiT, 19 double +
# 38 single blocks of 24 heads of 128; T5-XXL-sized encoder; CLIP-L/14
# text; WAN VAE) through the runner, the B1-B3 kernels at its shapes, a
# card-vs-CPU check at a small head-128 MMDiT, and its checkpoint layout
# ---------------------------------------------------------------------------

OPENSORA = dict(name="opensora", preset="opensora_v2",
                lr={"delta_a": 1e-3, "lora": 1e-3, "full": 1e-4},
                # full's weights, gradients and AdamW moments at 11.8B are about
                # 142 GB: full runs at full width with this depth cut
                full_depth=(4, 8), ckpt_seed=13, small_seed=17,
                # the runner's serving, lever, delta_a and lora runs: 10 + 19 of
                # the 19 + 38 blocks (the script's time limit, beside [mesh]'s
                # runs at 24 of LongCat's 48 blocks)
                run_depth=(10, 19))
# the lever request of both joint-attention backbones (Open-Sora v2,
# CogVideoX): W8A8, PAB and CFG reuse every 2, 2-step segments and one
# dense generation for the fidelity record
JOINT_LEVERS = ["--quantize-decode", "int8", "--pab-every", "2", "--cfg-reuse-every",
                "2", "--gen-segment-steps", "2", "--fast-decode-verify", "1"]


def joint_step_launches(n_attn: int):
    """Launches per kernel of one train step of a joint-attention backbone
    (the MMDiT, CogVideoX) with full remat. For each of the three methods
    every attention's q, k and v depend on the trainable tensors (delta_a's
    vec or time embedding reaches every block's modulation; LoRA patches
    the MMDiT's double blocks' qkv and single blocks' linear1, and
    CogVideoX's to_q / to_k / to_v; full trains every weight): each
    attention runs forward twice (the step and the recompute), the dQ
    kernel once and the dK/dV kernel once."""
    return {"flash_fwd": 2 * n_attn, "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn}


def joint_gen_launches(n_attn: int, *, steps: int, pab_every: int = 0) -> int:
    """Forward launches of one joint-volume generation: every joint
    attention per denoising step (one launch for the CFG batch, the
    MMDiT's 3 rows or CogVideoX's 2, one for the conditional row alone on
    a CFG-reuse step), none on the steps PAB reuses
    (``sampler._pab_reuse_flags`` over [0.1, 0.9) of the steps)."""
    from longcat_video_tta_tpu_torch.config import PABConfig
    from longcat_video_tta_tpu_torch.pipeline.sampler import _pab_reuse_flags

    if pab_every <= 0:
        return n_attn * steps
    reused = sum(_pab_reuse_flags(steps, PABConfig(every=pab_every)))
    return n_attn * (steps - reused)


def joint_run_launches(n_attn: int, *, steps: int, anchors: int, anchor_draws: int,
                          inference_steps: int):
    """Launches per kernel of one video of a TTA run: ``steps`` train
    steps, ``anchors`` anchor evals of ``anchor_draws`` B-row forwards
    each (sigmas x noise draws), then one generation."""
    out = {k: steps * n for k, n in joint_step_launches(n_attn).items()}
    out["flash_fwd"] += (anchors * anchor_draws * n_attn
                         + joint_gen_launches(n_attn, steps=inference_steps))
    return out


def opensora_small_config():
    """A small MMDiT whose head_dim is 128, for the card-vs-CPU checks:
    hidden 256, 2 heads of 128 with the published axes_dims (16, 56, 56),
    mlp ratio 4, 2 double + 2 single blocks, bf16; the tiny preset's VAE,
    T5 and CLIP widths (opensora_v2_tiny runs head_dim 16, which the
    kernels do not take)."""
    import dataclasses

    from longcat_video_tta_tpu_torch.models.backbones import opensora_v2_tiny

    base = opensora_v2_tiny()
    return dataclasses.replace(base, dit=dataclasses.replace(
        base.dit, hidden_size=256, num_heads=2, axes_dims=(16, 56, 56), mlp_ratio=4.0,
        param_dtype="bfloat16", compute_dtype="bfloat16"))


def depth_cut_config(depth, preset: str):
    """``preset`` with its DiT cut to ``depth``: a block count (CogVideoX)
    or (double, single) block counts (the MMDiT)."""
    import dataclasses

    from longcat_video_tta_tpu_torch.config import get_model_config

    base = get_model_config(preset)
    cut = (dict(depth=depth) if isinstance(depth, int)
           else dict(depth_double=depth[0], depth_single=depth[1]))
    return dataclasses.replace(base, dit=dataclasses.replace(base.dit, **cut))


def n_joint_attn(dit_cfg) -> int:
    """Joint attentions per forward: CogVideoX's blocks, the MMDiT's double
    and single blocks."""
    if dit_cfg.arch == "cogvideox":
        return dit_cfg.depth
    return dit_cfg.depth_double + dit_cfg.depth_single


# The script's time limit: the lever runs, [checkpoint], [eval], [t2v],
# [vbench] and [vp] run LongCat-13.6B at 12 of its 48 blocks (full widths;
# at 24, beside [mesh]'s runs at 24, a run took 1187.5 s of the 1200);
# the serving and delta_a main paths, [remat] and [bucket] keep all 48.
CUT_DEPTH = 12


def at_cut_depth(phase):
    """``phase`` with the runner's longcat_13b cut to ``CUT_DEPTH`` blocks."""
    def run(*args):
        with preset_depth(CUT_DEPTH, "longcat_13b"):
            return phase(*args)
    return run


class preset_depth:
    """Within the block, the runner's ``preset`` has the depth cut; not a
    preset of the package. The runner reads ``config.get_model_config``
    when it is called, never at import (tests/test_torch_mmdit_runner.py
    holds it to that)."""

    def __init__(self, depth, preset: str = "opensora_v2"):
        self.depth, self.preset = depth, preset

    def __enter__(self):
        from longcat_video_tta_tpu_torch import config

        self._orig = config.get_model_config
        cut = depth_cut_config(self.depth, self.preset)
        config.get_model_config = (lambda preset: cut if preset == self.preset
                                   else self._orig(preset))
        return self

    def __exit__(self, *exc):
        from longcat_video_tta_tpu_torch import config

        config.get_model_config = self._orig
        return False


def opensora_shapes():
    """(text tokens, tokens per latent frame, serving S, train S, anchor S)
    of the Open-Sora runs at chip_smoke's geometries: T5 pads to 512; 480 x
    832 is 60 x 104 latents, 30 x 52 = 1560 tokens after the 2 x 2 patch;
    serving 5 cond + 8 generated frames = 2 + 3 latents; the TTA window's
    cond + train latents, and cond + val for the anchor."""
    from longcat_video_tta_tpu_torch.models.backbones import opensora_v2

    cfg = opensora_v2()
    L = cfg.text.max_length
    per = (MAIN["height"] // 16) * (MAIN["width"] // 16)
    n_cond_lat = 1 + (MAIN["cond_frames"] - 1) // 4
    n_gen_lat = (((MAIN["gen_frames"] - 1 + 3) // 4) * 4) // 4 + 1
    c, t, v = tta_split()
    return L, per, L + (n_cond_lat + n_gen_lat) * per, L + (c + t) * per, L + (c + v) * per


def phase_opensora_kernels(fa):
    """B1 at the serving shape (3 CFG rows, 8312 joint tokens, no prefix,
    a ragged tail of 120), the anchor eval's (1 row of 8312) and the train
    step's (11 432, tail 40); B2 and B3 at the train step's. The 38 single
    blocks (2/3 of the launches) take v as a strided view of linear1's
    output (token stride 3 H D + mlp = 21 504), the 19 double blocks a
    contiguous one: the serving and train shapes are checked in both
    layouts, and a small ragged case in the strided one."""
    from longcat_video_tta_tpu_torch.models.backbones import opensora_v2

    dit = opensora_v2().dit
    H, D, mlp = dit.num_heads, dit.head_dim, dit.mlp_dim
    L, _, s_serve, s_train, s_anchor = opensora_shapes()
    fwd = [check_kernel_case(fa, "os_serve_joint", 3, H, s_serve, s_serve, D, timed=True,
                             seed=51),
           check_kernel_case(fa, "os_anchor_joint", 1, H, s_anchor, s_anchor, D,
                             timed=True, seed=52),
           check_kernel_case(fa, "os_train_joint", 1, H, s_train, s_train, D, timed=True,
                             seed=53),
           check_kernel_case(fa, "os_serve_single_v", 3, H, s_serve, s_serve, D,
                             fused_v_mlp=mlp, seed=56),
           check_kernel_case(fa, "os_train_single_v", 1, H, s_train, s_train, D,
                             fused_v_mlp=mlp, seed=57)]
    bwd = check_bwd_case(fa, "os_train_joint", 1, H, s_train, s_train, D, timed=True,
                         seed=54)
    bwd += check_bwd_case(fa, "os_train_single_v", 1, H, s_train, s_train, D,
                          fused_v_mlp=mlp, seed=58)
    fwd.append(check_kernel_case(fa, "os_single_strided_v", 2, 2, 700, 700, D,
                                 fused_v_mlp=1024, seed=55))
    bwd += check_bwd_case(fa, "os_single_strided_v", 2, 2, 700, 700, D, fused_v_mlp=1024,
                          seed=55)
    for c in fwd:
        print("[opensora kernel] " + json.dumps(c))
    for c in bwd:
        print("[opensora bwd-kernel] " + json.dumps(c))
    return fwd, bwd


def _joint_step(loss_fn, text_keys, scheme, tp, dit, d, dev):
    """Loss and flattened gradient of one train step of a joint backbone's
    scheme; ``text_keys`` name the inputs of ``d`` the loss takes after the
    target (None passes None)."""
    import torch

    leaves = {k: v.to(dev).clone().requires_grad_(True) for k, v in tp.items()}
    fwd_dit, ad = scheme.to_forward(leaves, dit)
    loss = loss_fn(fwd_dit, d["cond"], d["target"],
                   *(None if k is None else d[k] for k in text_keys),
                   adapters=ad, sigma=d["sigma"], noise=d["noise"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), torch.cat([g.double().flatten().cpu() for g in grads])


def _joint_agreement_reference(cfg, seed: int, rng_seed: int, arrays_of, methods, loss_fn,
                               text_keys):
    """The CPU side of a joint backbone's card-vs-CPU check: the small
    model's bundle (and an untouched copy of its DiT for the card), its
    generate_vc output on 5 cond + 9 generated frames, and each method's
    trainable tensors (moved off zero but for full's, so every tensor gets
    a gradient), loss and gradient."""
    import copy

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import AdapterConfig
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle, generate_vc
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

    cpu = ModelBundle.init_random(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(rng_seed)
    cond = rng.uniform(-1, 1, (1, 3, 5, 64, 128)).astype(np.float32)
    # 5 cond + 9 generated frames: 2 + 3 latents of 8 x 16 (32 tokens each)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 5, 8, 16)).astype(np.float32))
    kw = dict(num_frames=9, num_inference_steps=3, init_x=x0)
    ref = dict(bundle=cpu, dit=copy.deepcopy(cpu.dit), cond=cond, kw=kw,
               gen=generate_vc(cpu, cond, AGREE_PROMPT, **kw), arrays=arrays_of(rng),
               steps={})
    d = _on_device(ref["arrays"], "cpu")
    for method in methods:
        scheme = build_scheme(cfg.dit, AdapterConfig(method=method))
        tp = scheme.init("cpu", dit=cpu.dit, generator=torch.Generator().manual_seed(5))
        if method != "full":
            tp = {k: v + 0.01 for k, v in tp.items()}
        ref["steps"][method] = (tp, _joint_step(loss_fn, text_keys, scheme, tp, cpu.dit, d,
                                                "cpu"))
    return ref


def _joint_agreement(fa, tag: str, name: str, ref: dict, n_launch: int, loss_fn, text_keys,
                     card: str = "cuda"):
    """generate_vc and each method's train step on the card against the CPU
    side ``ref``: PSNR >= E2E_PSNR_MIN and ``n_launch`` forward launches,
    the step agreement's gates."""
    import dataclasses

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import AdapterConfig
    from longcat_video_tta_tpu_torch.pipeline.pipeline import generate_vc
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

    cpu = ref["bundle"]
    gpu = dataclasses.replace(
        cpu, dit=ref["dit"].to(card), vae=_copy_to(cpu.vae, card),
        text=_copy_to(cpu.text, card),
        clip=None if cpu.clip is None else _copy_to(cpu.clip, card), device=torch.device(card))
    a = ref["gen"]
    fa.reset_launches()
    b = generate_vc(gpu, ref["cond"], AGREE_PROMPT, **ref["kw"])
    launches = fa.launches
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    psnr = float("inf") if mse == 0 else -10 * math.log10(mse)
    print(f"[{tag} agree] {name} generate_vc card vs cpu: shape {b.shape}, max|diff| "
          f"{float(np.abs(a - b).max()):.4g}, psnr {psnr:.2f} dB (min {E2E_PSNR_MIN}); "
          f"flash_fwd launches {launches} (expected {n_launch})")
    if not (np.isfinite(b).all() and psnr >= E2E_PSNR_MIN and launches == n_launch):
        raise AssertionError(f"card and CPU {name} generate_vc disagree")
    d = _on_device(ref["arrays"], card)
    for method, (tp, cpu_step) in ref["steps"].items():
        scheme = build_scheme(cpu.cfg.dit, AdapterConfig(method=method))
        _agree(f"{name} {method} step card vs cpu",
               *_joint_step(loss_fn, text_keys, scheme, tp, gpu.dit, d, card), *cpu_step)


def _copy_to(module, card: str):
    import copy

    return copy.deepcopy(module).to(card)


def _on_device(arrays, dev):
    """numpy arrays as fp32 tensors on ``dev``."""
    import numpy as np
    import torch

    return {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in arrays.items()}


def opensora_agreement_reference() -> dict:
    """The CPU side of ``phase_opensora_agreement``."""
    import numpy as np

    from longcat_video_tta_tpu_torch.tta.losses import mmdit_flow_matching_loss_conditioned

    cfg = opensora_small_config()
    arrays_of = lambda rng: dict(
        cond=rng.standard_normal((1, 16, 2, 8, 16)),
        target=rng.standard_normal((1, 16, 1, 8, 16)),
        txt=rng.standard_normal((1, 16, cfg.dit.context_in_dim)),
        yv=rng.standard_normal((1, cfg.dit.vec_in_dim)),
        sigma=np.array([0.6]), noise=rng.standard_normal((1, 16, 1, 8, 16)))
    return _joint_agreement_reference(cfg, OPENSORA["small_seed"], 8, arrays_of,
                                      ("delta_a", "lora"),
                                      mmdit_flow_matching_loss_conditioned, ("txt", "yv"))


def phase_opensora_agreement(fa, ref=None):
    """The small head-128 MMDiT (``opensora_small_config``): generate_vc on
    the card against the CPU plain path on the same weights and initial
    volume, and one delta_a and one LoRA train step's loss and gradient,
    same injected sigma and noise (``ref``: the CPU side, from
    ``opensora_agreement_reference``)."""
    from longcat_video_tta_tpu_torch.tta.losses import mmdit_flow_matching_loss_conditioned

    cfg = opensora_small_config()
    _joint_agreement(fa, "opensora", "small MMDiT (hidden 256, 2 heads of 128)",
                     ref or opensora_agreement_reference(),
                     3 * (cfg.dit.depth_double + cfg.dit.depth_single),
                     mmdit_flow_matching_loss_conditioned, ("txt", "yv"))


def joint_run(fa, spec, tag: str, method: str, argv_extra, *, depth=None):
    """One runner call on ``spec``'s preset (OPENSORA or COGVIDEOX;
    ``depth``: the cut of ``preset_depth``); returns (summary, launches,
    wall s, peak GiB)."""
    import gc

    import torch

    from longcat_video_tta_tpu_torch.runners import run_tta

    name = spec["name"]
    out_dir = os.path.join(RUN_DIR, f"{name}_{tag}")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--method", method, "--preset", spec["preset"], "--output-dir", out_dir,
            "--device", "cuda", "--height", str(MAIN["height"]),
            "--width", str(MAIN["width"]), "--no-save-videos", *argv_extra]
    cut = ("" if not depth else f" (depth cut: {depth} blocks)" if isinstance(depth, int)
           else f" (depth cut: {depth[0]} double + {depth[1]} single blocks)")
    print(f"[{name} {tag}] run_tta " + " ".join(argv) + cut)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.time()
    if depth:
        with preset_depth(depth, spec["preset"]):
            summary = run_tta.main(argv)
    else:
        summary = run_tta.main(argv)
    wall = time.time() - t0
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shutil.rmtree(out_dir, ignore_errors=True)
    for i, r in enumerate(summary["results"]):
        es = r.get("early_stopping_info") or {}
        print(f"[{name} {tag}] video {i}: success={r['success']} "
              f"train_time={r.get('train_time')} s es_check_time={r.get('es_check_time')} s "
              f"gen_time={r.get('gen_time')} s total_time={r.get('total_time')} s "
              f"losses={r.get('losses')} anchors={[x for _, x in es.get('loss_history', [])]}"
              f" adapter_norm={r.get('adapter_norm')} "
              f"trainable_params={r.get('trainable_params')} psnr={r.get('psnr')} "
              f"ssim={r.get('ssim')}"
              + (f" fast_decode_verify={json.dumps(r['fast_decode_verify'])}"
                 if "fast_decode_verify" in r else "")
              + (f" error={r['error']}" if "error" in r else ""))
    print(f"[{name} {tag}] wall {wall:.1f} s; max_memory_allocated {peak:.2f} GiB; "
          f"launches {got}")
    return summary, got, wall, peak


def _check_run(tag, summary, got, expected, n_videos):
    """``tag``: "<backbone> <run>"."""
    import numpy as np

    if summary["num_success"] != n_videos:
        raise AssertionError(f"{tag}: {summary['num_success']}/{n_videos} "
                             f"succeeded: {[r.get('error') for r in summary['results']]}")
    for r in summary["results"]:
        if not np.isfinite([r["psnr"], r["ssim"]]).all():
            raise AssertionError(f"{tag}: non-finite metrics: {r}")
    print(f"[{tag}] launches expected {expected}")
    if got != expected:
        raise AssertionError(f"{tag}: launches {got}, expected {expected}")


def opensora_trainable(method: str, dit_cfg) -> int:
    """The trainable count each TTA run must report, from the widths."""
    import torch

    from longcat_video_tta_tpu_torch.models.mmdit import MMDiT, count_params

    D, mlp, r = dit_cfg.hidden_size, dit_cfg.mlp_dim, 8
    if method == "delta_a":
        return D
    if method == "lora":  # img/txt qkv and proj on the double blocks, lin1/lin2 single
        dbl = 2 * ((D * r + r * 3 * D) + (D * r + r * D))
        sgl = (D * r + r * (3 * D + mlp)) + ((D + mlp) * r + r * D)
        return dit_cfg.depth_double * dbl + dit_cfg.depth_single * sgl
    with torch.device("meta"):
        return count_params(MMDiT(dit_cfg))


def phase_joint_runs(fa, spec):
    """The runner on ``spec``'s preset (OPENSORA or COGVIDEOX) at full width:
    serving (2 requests), the lever request, delta_a (1 video on the TTA
    window), lora (3 steps) and full at the depth cut (3 steps). Returns the
    launches summed over them and the serving request times."""
    import numpy as np

    from longcat_video_tta_tpu_torch.config import get_model_config

    name = spec["name"]
    dit_cfg = get_model_config(spec["preset"]).dit
    n_attn = n_joint_attn(dit_cfg)
    trainable = opensora_trainable if dit_cfg.arch == "mmdit" else cogvideox_trainable
    serve = ["--num-cond-frames", str(MAIN["cond_frames"]),
             "--num-frames", str(MAIN["gen_frames"]),
             "--num-inference-steps", str(MAIN["steps"]),
             "--guidance-scale", str(MAIN["guidance"])]
    total = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

    def add(got):
        for k in total:
            total[k] += got[k]

    summary, got, _, _ = joint_run(fa, spec, "serve", "none",
                                   ["--synthetic", str(MAIN["requests"]), *serve])
    expected = {"flash_fwd": MAIN["requests"] * joint_gen_launches(
        n_attn, steps=MAIN["steps"]), "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    _check_run(f"{name} serve", summary, got, expected, MAIN["requests"])
    add(got)
    serve_times = [r["gen_time"] for r in summary["results"]]

    summary, got, _, _ = joint_run(fa, spec, "levers", "none",
                                   ["--synthetic", "1", "--caption-guard-mode", "off",
                                    *serve, *JOINT_LEVERS])
    expected = {"flash_fwd": joint_gen_launches(n_attn, steps=MAIN["steps"], pab_every=2)
                + joint_gen_launches(n_attn, steps=MAIN["steps"]),
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    _check_run(f"{name} levers", summary, got, expected, 1)
    fdv = summary["fast_decode_verify"]
    if not (fdv and np.isfinite(fdv.get("psnr_fast_vs_dense_mean", np.nan))):
        raise AssertionError(f"{name} levers: no finite fast_decode_verify: {fdv}")
    print(f"[{name} levers] gen_time {summary['results'][0]['gen_time']} s, "
          f"psnr_fast_vs_dense_mean {fdv['psnr_fast_vs_dense_mean']}")
    add(got)

    window = ["--num-cond-frames", str(TTA["cond_frames"]),
              "--tta-total-frames", str(TTA["tta_total_frames"]),
              "--num-frames", str(TTA["gen_frames"]),
              "--guidance-scale", str(TTA["guidance"]), "--caption-guard-mode", "off",
              "--synthetic", "1"]
    runs = {"delta_a": dict(steps=TTA["tta_steps"], check=TTA["check_every"],
                            inference=TTA["inference_steps"]),
            "lora": dict(steps=METHOD["steps"], check=METHOD["check_every"],
                         inference=METHOD["inference_steps"]),
            "full": dict(steps=METHOD["steps"], check=METHOD["check_every"],
                         inference=METHOD["inference_steps"], depth=spec["full_depth"])}
    for method, run in runs.items():
        depth = run.get("depth")
        cfg = depth_cut_config(depth, spec["preset"]).dit if depth else dit_cfg
        argv = [*window, "--steps", str(run["steps"]), "--lr", str(spec["lr"][method]),
                "--es-check-every", str(run["check"]), "--es-patience", str(TTA["patience"]),
                "--num-inference-steps", str(run["inference"])]
        summary, got, wall, peak = joint_run(fa, spec, method, method, argv, depth=depth)
        anchors = 1 + run["steps"] // run["check"]
        expected = joint_run_launches(n_joint_attn(cfg), steps=run["steps"],
                                      anchors=anchors, anchor_draws=6,
                                      inference_steps=run["inference"])
        _check_run(f"{name} {method}", summary, got, expected, 1)
        r = summary["results"][0]
        history = [x for _, x in r["early_stopping_info"]["loss_history"]]
        want = trainable(method, cfg)
        if not (np.isfinite(r["losses"] + history).all()
                and len(r["losses"]) == run["steps"] and len(history) == anchors
                and history[-1] != history[0] and r["trainable_params"] == want):
            raise AssertionError(f"{name} {method}: did not train, non-finite values or "
                                 f"trainable {r['trainable_params']} != {want}: {r}")
        print(f"[{name} {method}] trainable {want}, train step "
              f"{r['train_time'] / run['steps']:.3f} s, anchor eval (es_check_time / "
              f"{anchors}) {r['es_check_time'] / anchors:.3f} s, gen_time {r['gen_time']} s, "
              f"peak {peak:.2f} GiB, wall {wall:.1f} s")
        add(got)
    return total, serve_times


_OS_NAMES = [(r"\.in_layer\.", ".w1."), (r"\.out_layer\.", ".w2."),
             (r"_mod\.lin\.", "_mod."), (r"\.norm\.query_norm\.scale$", ".q_norm"),
             (r"\.norm\.key_norm\.scale$", ".k_norm"), (r"_mlp\.0\.", "_mlp.w_in."),
             (r"_mlp\.2\.", "_mlp.w_out."), (r"\.modulation\.lin\.", ".mod."),
             (r"^final_layer\.adaLN_modulation\.1\.", "final.adaln."),
             (r"^final_layer\.linear\.", "final.proj.")]
_CLIP_NAMES = [(r"^text_model\.embeddings\.token_embedding\.weight$", "token_embedding"),
               (r"^text_model\.embeddings\.position_embedding\.weight$",
                "position_embedding"),
               (r"^text_model\.final_layer_norm\.", "final_ln."),
               (r"^text_model\.", ""), (r"layer_norm1", "ln1"), (r"layer_norm2", "ln2"),
               (r"self_attn\.q_proj", "q"), (r"self_attn\.k_proj", "k"),
               (r"self_attn\.v_proj", "v"), (r"self_attn\.out_proj", "out"),
               (r"mlp\.fc", "fc")]


def expected_opensora_tensors(component: str, key: str, value, cfg):
    """[(port name, expected tensor)] of one upstream Open-Sora tensor,
    written out independently of the converter: Flux names to the port's;
    the q and k rows of each head of a fused qkv (and of linear1's first
    2D rows), their biases and the q/k norm scales reordered from
    interleaved pairs to halves (even channels, then odd)."""
    import torch

    if component in ("vae", "text_encoder"):
        return expected_port_tensors(component, key, value, cfg.vae)
    table = _OS_NAMES if component == "dit" else _CLIP_NAMES
    name = key
    for pat, rep in table:
        name = re.sub(pat, rep, name)
    if component == "dit":
        nH, dh = cfg.dit.num_heads, cfg.dit.head_dim
        halves = torch.cat([torch.arange(0, dh, 2), torch.arange(1, dh, 2)]).to(value.device)
        if key.endswith(("query_norm.scale", "key_norm.scale")):
            value = value[halves]
        elif ".qkv." in key or ".linear1." in key:
            value = value.clone()
            for h in range(2 * nH):  # the q heads, then the k heads
                rows = value[h * dh:(h + 1) * dh].clone()
                value[h * dh:(h + 1) * dh] = rows[halves]
    return [(name, value)]


def opensora_sample_keys(cfg):
    """Every kind of key of the four components at the first and last
    block."""
    d, s, L = cfg.dit.depth_double, cfg.dit.depth_single, cfg.clip.num_layers
    keys = {"dit": ["img_in.weight", "txt_in.bias", "cond_in.weight",
                    "time_in.in_layer.weight", "vector_in.out_layer.bias",
                    "final_layer.adaLN_modulation.1.weight", "final_layer.linear.weight"],
            "clip": ["text_model.embeddings.token_embedding.weight",
                     "text_model.embeddings.position_embedding.weight",
                     "text_model.final_layer_norm.bias"],
            "text_encoder": ["shared.weight", "encoder.block.0.layer.0.SelfAttention.q.weight",
                             "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
                             ".weight", "encoder.final_layer_norm.weight"],
            "vae": ["encoder.conv1.weight", "decoder.head.2.weight", "conv1.weight"]}
    for i in sorted({0, d - 1}):
        keys["dit"] += [f"double_blocks.{i}.{n}" for n in (
            "img_mod.lin.weight", "img_attn.qkv.weight", "img_attn.qkv.bias",
            "txt_attn.qkv.weight", "img_attn.norm.query_norm.scale",
            "txt_attn.norm.key_norm.scale", "img_attn.proj.weight", "txt_mlp.0.weight",
            "img_mlp.2.bias")]
    for i in sorted({0, s - 1}):
        keys["dit"] += [f"single_blocks.{i}.{n}" for n in (
            "linear1.weight", "linear1.bias", "linear2.weight", "norm.query_norm.scale",
            "norm.key_norm.scale", "modulation.lin.weight")]
    for i in sorted({0, L - 1}):
        keys["clip"] += [f"text_model.encoder.layers.{i}.{n}" for n in (
            "layer_norm1.weight", "self_attn.q_proj.weight", "self_attn.out_proj.bias",
            "mlp.fc1.weight", "layer_norm2.bias")]
    return keys


def phase_opensora_checkpoint(fa):
    """Synthesized shards (<dir>/{dit,vae,text_encoder,clip}, bf16, full
    width at the depth cut) written under .chip_smoke/: dit/ and clip/ in
    Open-Sora v2's layout, text_encoder/ in the UMT5 per-block layout
    (a relative_attention_bias in every block) that the JAX converter
    reads, where T5 v1.1 has one in block 0 only. Loaded
    through the runner's --checkpoint-dir, sampled tensors held against
    their shard values, then one serving request on them."""
    import tempfile

    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.models.convert import MMDIT_STATE_SHAPES
    from longcat_video_tta_tpu_torch.runners import run_tta

    depth = OPENSORA["full_depth"]
    cfg = depth_cut_config(depth, OPENSORA["preset"])
    folder = tempfile.mkdtemp(prefix="ckpt-os-", dir=RUN_DIR)
    try:
        t0 = time.time()
        nbytes, kept = write_checkpoint(folder, cfg, OPENSORA["ckpt_seed"],
                                        opensora_sample_keys(cfg),
                                        shapes=MMDIT_STATE_SHAPES)
        print(f"[opensora ckpt] wrote {nbytes / 1e9:.2f} GB of bf16 shards "
              f"(dit at {depth[0]} double + {depth[1]} single blocks) in "
              f"{time.time() - t0:.1f} s")
        base = ["--preset", OPENSORA["preset"], "--device", "cuda", "--checkpoint-dir",
                folder]
        args = run_tta.build_arg_parser().parse_args(
            base + ["--output-dir", os.path.join(RUN_DIR, "os_ckpt_run")])
        with preset_depth(depth, OPENSORA["preset"]):
            torch.cuda.synchronize()
            t0 = time.time()
            bundle = run_tta.load_bundle(args)
            torch.cuda.synchronize()
            t_load = time.time() - t0
        mods = {"dit": bundle.dit, "vae": bundle.vae, "text_encoder": bundle.text,
                "clip": bundle.clip}
        checked = 0
        for component, drawn in kept.items():
            params = mods[component].state_dict()
            for key, value in drawn.items():
                for name, want in expected_opensora_tensors(component, key, value, cfg):
                    if not torch.equal(params[name], want.to(params[name].dtype)):
                        raise AssertionError(f"{component} {key} -> {name}: loaded tensor "
                                             "differs from the shard value")
                    checked += 1
        print(f"[opensora ckpt] load {t_load:.2f} s ({nbytes / t_load / 1e9:.2f} GB/s); "
              f"{checked} loaded tensors equal their shard values after the transform")
        if checked < 50:
            raise AssertionError(f"only {checked} tensors checked")
        del bundle, mods, kept
        serve = ["--checkpoint-dir", folder, "--synthetic", "1",
                 "--num-cond-frames", str(MAIN["cond_frames"]),
                 "--num-frames", str(MAIN["gen_frames"]),
                 "--num-inference-steps", str(MAIN["steps"]),
                 "--guidance-scale", str(MAIN["guidance"]), "--caption-guard-mode", "off"]
        summary, got, _, _ = joint_run(fa, OPENSORA, "ckpt_serve", "none", serve,
                                       depth=depth)
        n = cfg.dit.depth_double + cfg.dit.depth_single
        _check_run("opensora ckpt_serve", summary, got, {
            "flash_fwd": joint_gen_launches(n, steps=MAIN["steps"]),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, 1)
        if not np.isfinite(summary["results"][0]["psnr"]):
            raise AssertionError("opensora checkpoint request: non-finite psnr")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return got


def phase_opensora(fa, agree_ref=None):
    """(a) B1-B3 at the Open-Sora shapes, (b) card vs CPU at the small
    head-128 MMDiT (``agree_ref``: its CPU side, computed here when None),
    (c) the runner at full width, (d) the checkpoint layout. Returns
    (forward cases, backward cases, launches summed over the runs)."""
    import torch

    fwd, bwd = phase_opensora_kernels(fa)
    torch.cuda.empty_cache()
    phase_opensora_agreement(fa, agree_ref)
    torch.cuda.empty_cache()
    with preset_depth(OPENSORA["run_depth"], OPENSORA["preset"]):
        launches, serve_times = phase_joint_runs(fa, OPENSORA)
    print(f"[opensora] serving gen_time per request {serve_times} s")
    got = phase_opensora_checkpoint(fa)
    for k in launches:
        launches[k] += got[k]
    print(f"[opensora] launches over the runs {launches}")
    return fwd, bwd, launches


# ---------------------------------------------------------------------------
# CogVideoX path: the cogvideox_5b preset (5.57B DiT, 42 blocks of 48 heads
# of 64; T5-XXL-sized encoder, 226 tokens; the WAN VAE at base 128) through
# the runner, B1-B3 at head_dim 64, and a card-vs-CPU check at a small
# head-64 CogVideoX
# ---------------------------------------------------------------------------

COGVIDEOX = dict(name="cogvideox", preset="cogvideox_5b",
                 lr={"delta_a": 1e-3, "lora": 1e-3, "full": 1e-4},
                 # full's weights, gradients and AdamW moments at 5.57B are about
                 # 67 GB, beside the 9.5 GB encoder and the best snapshot: full
                 # runs at full width with this depth cut (2.11B)
                 full_depth=16, small_seed=19,
                 # the runner's serving, lever, delta_a and lora runs: 21 of the
                 # 42 blocks (the script's time limit, as Open-Sora's)
                 run_depth=21)


def cogvideox_shapes():
    """(serving S, train S, anchor S) of the CogVideoX runs at chip_smoke's
    geometries: 226 text tokens plus 1560 per latent frame at 480 x 832;
    serving 5 cond + 8 generated frames = 2 + 3 latents, the TTA window's
    cond + train latents, and cond + val for the anchor."""
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_5b

    L = cogvideox_5b().text.max_length
    per = (MAIN["height"] // 16) * (MAIN["width"] // 16)
    n_cond_lat = 1 + (MAIN["cond_frames"] - 1) // 4
    n_gen_lat = (((MAIN["gen_frames"] - 1 + 3) // 4) * 4) // 4 + 1
    c, t, v = tta_split()
    return L + (n_cond_lat + n_gen_lat) * per, L + (c + t) * per, L + (c + v) * per


def phase_cogvideox_kernels(fa):
    """B1 at the serving shape (2 CFG rows of 8026 joint tokens, 48 heads of
    64, no mask, a ragged tail of 90), the anchor eval's (1 row of 8026) and
    the train step's (11 146, tail 10); B2 and B3 at the train step's."""
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_5b

    dit = cogvideox_5b().dit
    H, D = dit.num_heads, dit.head_dim
    s_serve, s_train, s_anchor = cogvideox_shapes()
    fwd = [check_kernel_case(fa, "cvx_serve_joint_d64", 2, H, s_serve, s_serve, D,
                             timed=True, seed=61),
           check_kernel_case(fa, "cvx_anchor_joint_d64", 1, H, s_anchor, s_anchor, D,
                             timed=True, seed=62),
           check_kernel_case(fa, "cvx_train_joint_d64", 1, H, s_train, s_train, D,
                             timed=True, seed=63)]
    bwd = check_bwd_case(fa, "cvx_train_joint_d64", 1, H, s_train, s_train, D, timed=True,
                         seed=64)
    for c in fwd:
        print("[cogvideox kernel] " + json.dumps(c))
    for c in bwd:
        print("[cogvideox bwd-kernel] " + json.dumps(c))
    return fwd, bwd


def cogvideox_small_config():
    """A small CogVideoX whose head_dim is 64, for the card-vs-CPU checks:
    hidden 256, 4 heads of 64 with the published rope_dims (16, 24, 24), 2
    blocks, bf16; the tiny preset's VAE and T5 widths (16 text tokens;
    cogvideox_tiny runs head_dim 16, which the kernels do not take)."""
    import dataclasses

    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny

    base = cogvideox_tiny()
    return dataclasses.replace(base, dit=dataclasses.replace(
        base.dit, hidden_size=256, num_heads=4, rope_dims=(16, 24, 24), time_embed_dim=128,
        param_dtype="bfloat16", compute_dtype="bfloat16"))


def cogvideox_agreement_reference() -> dict:
    """The CPU side of ``phase_cogvideox_agreement``."""
    import numpy as np

    from longcat_video_tta_tpu_torch.tta.losses import (
        cogvideox_flow_matching_loss_conditioned,
    )

    cfg = cogvideox_small_config()
    arrays_of = lambda rng: dict(
        cond=rng.standard_normal((1, 16, 2, 8, 16)),
        target=rng.standard_normal((1, 16, 1, 8, 16)),
        txt=rng.standard_normal((1, 16, cfg.dit.text_dim)),
        sigma=np.array([0.6]), noise=rng.standard_normal((1, 16, 3, 8, 16)))
    return _joint_agreement_reference(cfg, COGVIDEOX["small_seed"], 9, arrays_of,
                                      ("delta_a", "lora", "full"),
                                      cogvideox_flow_matching_loss_conditioned, ("txt", None))


def phase_cogvideox_agreement(fa, ref=None):
    """The small head-64 CogVideoX (``cogvideox_small_config``): generate_vc
    on the card against the CPU plain path on the same weights and initial
    volume, and one delta_a, LoRA and full train step's loss and gradient,
    same injected sigma and noise (``ref``: the CPU side, from
    ``cogvideox_agreement_reference``)."""
    from longcat_video_tta_tpu_torch.tta.losses import (
        cogvideox_flow_matching_loss_conditioned,
    )

    cfg = cogvideox_small_config()
    _joint_agreement(fa, "cogvideox", "small CogVideoX (hidden 256, 4 heads of 64)",
                     ref or cogvideox_agreement_reference(), 3 * cfg.dit.depth,
                     cogvideox_flow_matching_loss_conditioned, ("txt", None))


def cogvideox_trainable(method: str, dit_cfg) -> int:
    """The trainable count each CogVideoX TTA run must report, from the
    widths: delta_a the time embedding's width; lora (rank 8) on to_q, to_k,
    to_v and to_out of every block; full every parameter."""
    import torch

    from longcat_video_tta_tpu_torch.models.cogvideox import CogVideoX, count_params

    D, r = dit_cfg.hidden_size, 8
    if method == "delta_a":
        return dit_cfg.time_embed_dim
    if method == "lora":
        return dit_cfg.depth * 4 * (D * r + r * D)
    with torch.device("meta"):
        return count_params(CogVideoX(dit_cfg))


def phase_cogvideox(fa, agree_ref=None):
    """(a) B1-B3 at the CogVideoX shapes (head_dim 64), (b) card vs CPU at
    the small head-64 CogVideoX (``agree_ref``: its CPU side, computed here
    when None), (c) the runner at full width. Returns (forward cases,
    backward cases, launches summed over the runs)."""
    import torch

    fwd, bwd = phase_cogvideox_kernels(fa)
    torch.cuda.empty_cache()
    phase_cogvideox_agreement(fa, agree_ref)
    torch.cuda.empty_cache()
    with preset_depth(COGVIDEOX["run_depth"], COGVIDEOX["preset"]):
        launches, serve_times = phase_joint_runs(fa, COGVIDEOX)
    print(f"[cogvideox] serving gen_time per request {serve_times} s")
    print(f"[cogvideox] launches over the runs {launches}")
    return fwd, bwd, launches


# ---------------------------------------------------------------------------
# the thin runners, the sweep runner and the VBench pair (LongCat-13.6B)
# ---------------------------------------------------------------------------

# text-to-video: 29 frames (8 latents x 1560 tokens = 12 480 per row, 2
# CFG rows) at 480x832, 4 denoising steps (not 50), guidance 4.0; 2 dense
# requests, then 1 with PAB and CFG reuse every 2
T2V = dict(height=480, width=832, frames=29, steps=4, guidance=4.0, requests=2,
           pab_every=2, cfg_reuse_every=2)
# the sweep row: delta_a on the demo campaign's 29-frame window, 3 steps
# with the anchor check every 3, 4 denoising steps, 8 generated frames,
# 1 synthetic video; then run_eval_adapters with BSA at keep 0.5
SWEEP = dict(series="chip_smoke_sweep", run_id="DELTA_A", steps=3, check_every=3,
             patience=3, inference_steps=4, lr=0.005, bsa_keep_ratio=0.5, seed=51)
VBENCH = dict(seed=61, frames=4, musiq_frames=2)


def t2v_kernel_cases(dit_cfg, tokens_per_frame):
    """B1 at the text-to-video shapes: self-attention over the 12 480
    tokens of 8 latents, no mask, the 2 CFG rows; cross-attention against
    the 512 text tokens (k, v fused as the DiT projects them)."""
    B, H, D = 2, dit_cfg.num_heads, dit_cfg.head_dim
    s = (1 + (T2V["frames"] - 1) // 4) * tokens_per_frame
    return [("t2v_self", (B, H, s, s, D), dict(seed=71)),
            ("t2v_cross", (B, H, s, dit_cfg.text_len, D), dict(fused_kv=True, seed=72))]


def phase_t2v(fa, dit_cfg, tokens_per_frame):
    """B1 at the t2v shapes (timed against the plain version and SDPA),
    then ``run_t2v.main`` at LongCat-13.6B width and depth: 2 dense
    requests (--data-dir of 2 captions), then 1 request (--prompt) with
    --pab-every 2 --cfg-reuse-every 2. Cuts: 4 denoising steps (not 50),
    29 frames (not 93). Each request's frames must be finite in [0, 1]
    and the forward kernel's launches must equal ``t2v_launches``."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.pipeline import pipeline
    from longcat_video_tta_tpu_torch.runners import run_t2v
    from longcat_video_tta_tpu_torch.runners.run_tta import make_synthetic_dataset

    cases = [check_kernel_case(fa, name, *shape, timed=True, **opts)
             for name, shape, opts in t2v_kernel_cases(dit_cfg, tokens_per_frame)]
    for c in cases:
        print("[t2v-kernel] " + json.dumps(c))
    out_dir = os.path.join(RUN_DIR, "t2v")
    shutil.rmtree(out_dir, ignore_errors=True)
    data = make_synthetic_dataset(os.path.join(out_dir, "captions"), T2V["requests"], 16, 32)
    common = ["--preset", "longcat_13b", "--device", "cuda", "--height", str(T2V["height"]),
              "--width", str(T2V["width"]), "--num-frames", str(T2V["frames"]),
              "--num-inference-steps", str(T2V["steps"]),
              "--guidance-scale", str(T2V["guidance"])]
    runs = [("dense", ["--data-dir", data, "--max-videos", str(T2V["requests"])],
             T2V["requests"] * t2v_launches(dit_cfg.depth, T2V["steps"])),
            ("pab_cfg_reuse", ["--prompt", "a red ball rolling across a wooden floor",
                               "--pab-every", str(T2V["pab_every"]),
                               "--cfg-reuse-every", str(T2V["cfg_reuse_every"])],
             t2v_launches(dit_cfg.depth, T2V["steps"], T2V["pab_every"],
                          T2V["cfg_reuse_every"]))]
    frames_seen = []
    real = pipeline.generate_t2v

    def spy(*a, **k):
        out = real(*a, **k)
        frames_seen.append((out.shape, bool(np.isfinite(out).all()), float(out.min()),
                            float(out.max())))
        return out

    launches, gen_times = 0, []
    pipeline.generate_t2v = spy
    try:
        for tag, flags, expected in runs:
            argv = ["--output-dir", os.path.join(out_dir, tag)] + common + flags
            print(f"[t2v] run_t2v {' '.join(argv)}")
            frames_seen.clear()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            t0 = time.time()
            results = run_t2v.main(argv)
            wall = time.time() - t0
            got = fa.launches
            gen_times += [r["gen_time"] for r in results]
            for r, f in zip(results, frames_seen):
                print(f"[t2v] {tag}: gen_time={r['gen_time']:.3f} s frames {f[0]} "
                      f"finite={f[1]} range [{f[2]:.4f}, {f[3]:.4f}]")
            print(f"[t2v] {tag}: wall {wall:.1f} s; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash_fwd launches "
                  f"{got} (expected {expected})")
            n_frames = 1 + 4 * ((T2V["frames"] - 1 + 3) // 4)
            if len(frames_seen) != len(results) or not all(
                    f[0] == (n_frames, T2V["height"], T2V["width"], 3) and f[1]
                    and 0.0 <= f[2] and f[3] <= 1.0 for f in frames_seen):
                raise AssertionError(f"[t2v] {tag}: frames out of bounds: {frames_seen}")
            if got != expected:
                raise AssertionError(f"[t2v] {tag}: flash_fwd launched {got} times, "
                                     f"expected {expected}")
            launches += got
    finally:
        pipeline.generate_t2v = real
    shutil.rmtree(out_dir, ignore_errors=True)
    return cases, launches, gen_times


def vbench_tower_agreement(paths: dict, smi: str, card: str = "cuda") -> dict:
    """DINO ViT-S/16 CLS features, CLIP-L/14 image embeds with the
    aesthetic head's scores, and MUSIQ-SPAQ scores, each on the card and on
    the CPU from the same file and inputs (4 frames at 480x832; MUSIQ 2),
    fp32, under [eval]'s gates; the card's ms per call."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.eval import musiq, vbench_native as vb
    from longcat_video_tta_tpu_torch.models import clip
    from longcat_video_tta_tpu_torch.utils.device import full_fp32

    rng = np.random.default_rng(VBENCH["seed"])
    frames = rng.random((VBENCH["frames"], 480, 832, 3), dtype=np.float32)
    devices, out = (card, "cpu"), {}
    with torch.no_grad(), full_fp32():
        res = {}
        for dev in devices:
            m = vb.load_dino_params(paths["dino"], device=dev)
            px = vb.preprocess_imagenet(frames, m.cfg.image_size, dev)
            res[dev] = (m, px, m(px))
        _agreement("dino preprocess 4x480x832 -> 224", res[card][1], res["cpu"][1])
        out["dino"] = _agreement("dino_vits16 CLS features", res[card][2], res["cpu"][2])
        m, px = res[card][:2]
        out["dino_ms"] = _events_ms(lambda: m(px), 10)
        res = {}
        for dev in devices:
            m, vcfg = vb.load_clip_l14(paths["clip_l14"], dev)
            head = vb.load_aesthetic_head(paths["aesthetic"], dev)
            px = clip.preprocess_frames(frames, vcfg.image_size, dev)
            emb = m.image_embed(px)
            res[dev] = (m, head, px, emb, head(emb))
        out["clip_l14"] = _agreement("clip_l14 image embeds", res[card][3], res["cpu"][3])
        out["aesthetic"] = _agreement("aesthetic head scores", res[card][4], res["cpu"][4])
        m, head, px = res[card][:3]
        out["aesthetic_ms"] = _events_ms(lambda: head(m.image_embed(px)),
                                         5)
        del res, m, head, px
        models = {dev: musiq.load_musiq_params(paths["musiq"], device=dev)
                  for dev in devices}
        toks = [musiq.build_multiscale_tokens(f, models["cpu"][1])
                for f in frames[:VBENCH["musiq_frames"]]]
        args = [np.stack([t[j] for t in toks]) for j in range(4)]
        n = np.asarray([t[4] for t in toks], np.int32)
        ms = {dev: (m, musiq.musiq_score(m, *args, n)) for dev, (m, _) in models.items()}
        out["musiq"] = _agreement("musiq_spaq scores", ms[card][1], ms["cpu"][1])
        out["musiq_ms"] = _events_ms(lambda: musiq.musiq_score(ms[card][0], *args, n), 10)
    print(f"[vbench-towers] {smi}: dino_vits16 {out['dino_ms']:.3f} ms per call "
          f"({VBENCH['frames']} frames at 224), clip_l14 + aesthetic head "
          f"{out['aesthetic_ms']:.3f} ms ({VBENCH['frames']} frames), musiq_spaq "
          f"{out['musiq_ms']:.3f} ms ({VBENCH['musiq_frames']} frames of {int(n[0])} "
          f"tokens + CLS)")
    return out


def sweep_eval_launches(depth: int, steps: int) -> dict:
    """Launches of one ``run_eval_adapters --bsa-keep-ratio`` generation
    (lever_launches' rule for a BSA request): the cond cache on the
    forward kernel (2 x depth), cross-attention on it every step (depth),
    self-attention through the BSA kernel every step (depth) with two
    block sums each."""
    return {"flash_fwd": 2 * depth + depth * steps, "bsa_fwd": depth * steps,
            "bsa_fwd_qk_int8": 0, "bsa_block_sum": 2 * depth * steps}


def phase_sweep(fa, bsa, depth: int, towers: str):
    """A configs/-style YAML row (campaign_demo_delta_a.yaml's schema:
    delta_a on longcat_13b, 1 synthetic video, --save-adapters,
    compute_vbench on the towers under ``towers``, compile_cache_dir "auto",
    which the sweep forwards) through the port's ``run_sweep``
    in-process; B1-B3 launches as ``method_launches``; online_eval.vbench
    from the native towers (five finite dimensions in [0, 1], no error).
    Then ``run_eval_adapters --mode adapted --bsa-keep-ratio 0.5`` on the
    row (B1, B4, B5 launches as ``sweep_eval_launches``), ``run_eval``'s
    best_configs and vbench modes and ``export_results`` over the output.
    Cuts: 1 video, 3 TTA steps, 4 denoising steps, 8 generated frames."""
    import gc

    import numpy as np
    import torch
    import yaml

    from longcat_video_tta_tpu_torch.eval.vbench import VBENCH_DIMENSIONS
    from longcat_video_tta_tpu_torch.runners import run_eval_adapters
    from longcat_video_tta_tpu_torch.sweep import export_results, run_eval, run_sweep

    base = os.path.join(RUN_DIR, "sweep")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    cfg = {"method": "delta_a", "series": SWEEP["series"], "series_name": SWEEP["series"],
           "description": "chip_smoke: delta_a at LongCat-13.6B width through the sweep",
           "fixed": {"preset": "longcat_13b", "synthetic": 1, "max_videos": 1,
                     "caption_guard_mode": "off", "height": TTA["height"],
                     "width": TTA["width"], "num_cond_frames": TTA["cond_frames"],
                     "tta_total_frames": TTA["tta_total_frames"],
                     "num_frames": TTA["gen_frames"], "steps": SWEEP["steps"],
                     "es_check_every": SWEEP["check_every"],
                     "es_patience": SWEEP["patience"],
                     "num_inference_steps": SWEEP["inference_steps"],
                     "guidance_scale": TTA["guidance"], "seed": SWEEP["seed"],
                     "save_adapters": True, "compute_vbench": True,
                     "vbench_towers_dir": towers,
                     "compile_cache_dir": "auto"},
           "sweep": [{"run_id": SWEEP["run_id"], "lr": SWEEP["lr"]}]}
    path = os.path.join(base, "chip_smoke_sweep.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    results = os.path.join(base, "results")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.time()
    rows = run_sweep.run_sweep(path, results, device="cuda")
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(results, f"sweep_{SWEEP['series']}.json")) as f:
        record = json.load(f)
    run_dir = os.path.join(results, SWEEP["series"], SWEEP["run_id"])
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    r = summary["results"][0]
    expected = method_launches("t_embed", depth, steps=SWEEP["steps"],
                               anchors=1 + SWEEP["steps"] // SWEEP["check_every"],
                               inference_steps=SWEEP["inference_steps"])
    vbench = summary["online_eval"].get("vbench", {})
    print(f"[sweep] rows {[(x['run_id'], x['status']) for x in rows]}; wall {wall:.1f} s; "
          f"max_memory_allocated {peak:.2f} GiB; "
          f"record {[(x['run_id'], x['status']) for x in record]}")
    print(f"[sweep] video: success={r['success']} train_time={r.get('train_time')} s "
          f"es_check_time={r.get('es_check_time')} s gen_time={r.get('gen_time')} s "
          f"total_time={r.get('total_time')} s psnr={r.get('psnr')} ssim={r.get('ssim')} "
          f"adapter_path={r.get('adapter_path')}"
          + (f" error={r['error']}" if "error" in r else ""))
    print(f"[sweep] launches {got} (expected {expected}); online_eval.vbench "
          f"{json.dumps({k: vbench.get(k) for k in ('backend', 'results', 'unavailable', 'error')})}")
    if [x["status"] for x in rows] != ["ok"] or [x["status"] for x in record] != ["ok"]:
        raise AssertionError(f"[sweep] row status {rows}")
    if summary["num_success"] != 1 or not r.get("adapter_path"):
        raise AssertionError(f"[sweep] the row's video failed or saved no adapter: {r}")
    if not (np.isfinite(r["losses"] + [r["psnr"], r["ssim"]]).all()
            and r["adapter_norm"] > 0):
        raise AssertionError(f"[sweep] row result out of bounds: {r}")
    if got != expected:
        raise AssertionError(f"[sweep] launches {got}, expected {expected}")
    if "error" in vbench or vbench.get("backend") != "torch-native" or vbench.get(
            "unavailable") or not all(
            np.isfinite(vbench["results"].get(d, np.nan))
            and 0.0 <= vbench["results"][d] <= 1.0 for d in VBENCH_DIMENSIONS):
        raise AssertionError(f"[sweep] online_eval.vbench: {vbench}")
    launches = dict(got)

    eval_dir = os.path.join(run_dir, "eval_bsa")
    argv = ["--results-dir", run_dir, "--output-dir", eval_dir, "--mode", "adapted",
            "--bsa-keep-ratio", str(SWEEP["bsa_keep_ratio"]), "--device", "cuda"]
    print("[sweep] run_eval_adapters " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    bsa.reset_launches()
    t0 = time.time()
    ev = run_eval_adapters.main(argv)
    wall = time.time() - t0
    got = {"flash_fwd": fa.launches, "bsa_fwd": bsa.bsa_launches,
           "bsa_fwd_qk_int8": bsa.bsa_int8_launches,
           "bsa_block_sum": bsa.bsa_block_sum_launches}
    gc.collect()
    torch.cuda.empty_cache()
    expected = sweep_eval_launches(depth, SWEEP["inference_steps"])
    e = ev["results"][0]
    print(f"[sweep] eval_adapters: success={e['success']} gen_time={e.get('gen_time')} s "
          f"psnr={e.get('psnr')} ssim={e.get('ssim')} (the run's dense psnr "
          f"{r['psnr']}); wall {wall:.1f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got} "
          f"(expected {expected})"
          + (f" error={e['error']}" if "error" in e else ""))
    if ev["num_success"] != 1 or not (np.isfinite(e["psnr"]) and np.isfinite(e["ssim"])):
        raise AssertionError(f"[sweep] run_eval_adapters: {ev}")
    if got != expected:
        raise AssertionError(f"[sweep] run_eval_adapters launches {got}, expected {expected}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v

    best = os.path.join(base, "best_configs.json")
    vb_out = os.path.join(base, "vbench_score.json")
    all_results = os.path.join(base, "all_results.json")
    t0 = time.time()
    run_eval.main(["--mode", "best_configs", "--results-roots", results, "--output", best])
    run_eval.main(["--mode", "vbench", "--gen-dir", os.path.join(run_dir, "videos"),
                   "--vbench-towers-dir", towers, "--device", "cuda", "--output", vb_out])
    export_results.main(["--results-roots", results, "--output", all_results])
    print(f"[sweep] run_eval best_configs + vbench, export_results in "
          f"{time.time() - t0:.1f} s")
    with open(best) as f:
        bc = json.load(f)
    with open(vb_out) as f:
        vbo = json.load(f)
    with open(all_results) as f:
        runs = json.load(f)["runs"]
    if bc.get(SWEEP["series"], {}).get("run_id") != SWEEP["run_id"]:
        raise AssertionError(f"[sweep] best_configs: {bc}")
    if vbo.get("backend") != "torch-native" or set(vbo["results"]) < set(VBENCH_DIMENSIONS):
        raise AssertionError(f"[sweep] run_eval vbench: {vbo}")
    if [(x["run_id"], x["status"]) for x in runs] != [(SWEEP["run_id"], "complete")]:
        raise AssertionError(f"[sweep] all_results.json runs: {runs}")
    shutil.rmtree(base, ignore_errors=True)
    return launches


def phase_vbench(fa, bsa, depth: int, smi: str):
    """The VBench towers at their published geometry drawn on the card and
    written under .chip_smoke/vbench_towers/ (removed at the end), their
    card-vs-CPU agreement, then the sweep row that scores with them."""
    towers = os.path.join(RUN_DIR, "vbench_towers")
    shutil.rmtree(towers, ignore_errors=True)
    t0 = time.time()
    paths = write_vbench_tower_files(towers, VBENCH["seed"], "cuda")
    print(f"[vbench-towers] tower files written in {time.time() - t0:.1f} s: "
          f"{sorted(os.path.basename(p) for p in paths.values())}")
    t0 = time.time()
    agree = vbench_tower_agreement(paths, smi)
    print(f"[time] vbench towers {time.time() - t0:.1f} s")
    try:
        t0 = time.time()
        launches = phase_sweep(fa, bsa, depth, towers)
        print(f"[time] sweep row {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(towers, ignore_errors=True)
    return agree, launches


# ---------------------------------------------------------------------------
# --video-parallel (the lanes folded into the batch axis), the debugging
# and profiling flags, and the post-processing tools
# ---------------------------------------------------------------------------

# [vp]: the delta_a path's window (29 frames: 4 cond, 3 train, 1 val
# latents) at LongCat-13.6B width and depth on 2 videos, 3 steps with the
# anchor check every 3, 4 denoising steps, --video-parallel 2
# --native-prefetch, against the same 2 videos run one after the other
VP = dict(videos=2, lanes=2, steps=3, check_every=3, inference_steps=4, seed=81,
          loss0_rtol=1e-3, loss_rtol=1e-2, cos_min=0.99, tower_seed=83)
# [flags]: one video at longcat_demo width (192 x 320, 8 blocks) per flag
FLAGS = dict(height=192, width=320, cond_frames=5, tta_total_frames=13, gen_frames=5,
             steps=2, check_every=1, inference_steps=2, seed=85, loss_rtol=1e-2)
# the [tools] gates: eval_external against the runner's metric code on the
# same saved clips; against the runner's recorded values the saved clip is
# the generation truncated to uint8, which moves each metric a little
TOOLS = dict(code_atol=1e-4, psnr_atol=0.1, ssim_atol=1e-2, lpips_atol=1e-2)


def vp_kernel_cases(dit_cfg, tokens_per_frame):
    """B1 at the shapes --video-parallel 2 folds the lanes into: the train
    step's self-attention and cross-attention at B 2, the anchor eval's
    self-attention at 12 rows (2 lanes x 3 sigmas x 2 draws)."""
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    n_cond_lat, n_train_lat, n_val_lat = tta_split()
    ncond = n_cond_lat * tokens_per_frame
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    s_anchor = (n_cond_lat + n_val_lat) * tokens_per_frame
    return [("vp_train_self", (VP["lanes"], H, s_train, s_train, D),
             dict(ncond=ncond, seed=91)),
            ("vp_anchor_self", (6 * VP["lanes"], H, s_anchor, s_anchor, D),
             dict(ncond=ncond, seed=92)),
            ("vp_train_cross", (VP["lanes"], H, s_train, dit_cfg.text_len, D),
             dict(fused_kv=True, seed=93))]


def vp_launches(graph: str, depth: int, *, lanes: int, steps: int, checks: int,
                inference_steps: int):
    """Launches per kernel of one --video-parallel group: ``steps`` batched
    train steps (each launches what one video's step launches: the lanes
    ride the batch axis), an anchor eval per lane at set-up and ``checks``
    batched ones (2 x depth forward launches each, every lane in one
    forward), then each lane's generation."""
    out = {k: steps * n for k, n in train_step_launches(graph, depth).items()}
    out["flash_fwd"] += 2 * depth * (lanes + checks + lanes * (1 + inference_steps))
    return out


def mesh_launches(kind: str, depth: int, ranks: int, *, steps: int, anchors: int,
                  inference_steps: int, lanes: int = 1, checks: int = 0):
    """Launches per kernel on each rank of a delta_a ("t_embed") mesh run of
    one video (``kind`` "context" or "tensor") or of one data rank's lanes
    of a --video-parallel group ("data"):
      "context"  P = ``ranks``: each self-attention is a ring of P chunk
                 launches (B1), its backward P dQ and P dK/dV chunk
                 launches; cross-attention stays one launch. A train step
                 (each block recomputed under remat): forward 2 x depth x
                 (P + 1), dQ depth x (P + 1), dK/dV depth x P; an anchor
                 eval depth x (P + 1); generation: the cond cache depth x
                 (P + 1), each decode step depth x (2P + 1) (the cache and
                 the fresh tokens are two pieces of each chunk);
      "tensor"   one rank's counts (the heads split, not the calls);
      "data"     ``vp_launches`` of this rank's ``lanes``."""
    if kind == "tensor":
        return method_launches("t_embed", depth, steps=steps, anchors=anchors,
                               inference_steps=inference_steps)
    if kind == "data":
        return vp_launches("t_embed", depth, lanes=lanes, steps=steps, checks=checks,
                           inference_steps=inference_steps)
    d, p = depth, ranks
    out = {"flash_fwd": steps * 2 * d * (p + 1), "flash_bwd_dq": steps * d * (p + 1),
           "flash_bwd_dkv": steps * d * p}
    out["flash_fwd"] += d * (p + 1) * (anchors + 1) + inference_steps * d * (2 * p + 1)
    return out


class PhaseProbe:
    """The runner's ``on_phase`` hook: at every phase mark, after a device
    sync, the time, the kernel counts, and the memory; the peak statistics
    are reset at the first "video" mark (after the weights are drawn). On
    another device than "cuda" (a CPU rehearsal) the memory reads 0."""

    def __init__(self, fa, card: str = "cuda"):
        self.fa, self.card, self.events = fa, card, []

    def __call__(self, name):
        import torch

        on_card = self.card == "cuda"
        if on_card:
            torch.cuda.synchronize()
            if name == "video" and not self.events:
                torch.cuda.reset_peak_memory_stats()
        fa = self.fa
        self.events.append(dict(name=name, t=time.perf_counter(), flash_fwd=fa.launches,
                                flash_bwd_dq=fa.bwd_dq_launches,
                                flash_bwd_dkv=fa.bwd_dkv_launches,
                                peak=torch.cuda.max_memory_allocated() if on_card else 0,
                                held=torch.cuda.memory_allocated() if on_card else 0))

    def first(self, name, after=0):
        return next(i for i, e in enumerate(self.events) if i >= after and e["name"] == name)

    def train_step(self, k: int):
        """(launches per train step, seconds per step, anchor eval seconds)
        of the first chunk of ``k`` steps."""
        i = self.first("train_chunk")
        j = self.first("anchor_check", i)
        a, b, c = self.events[i], self.events[j], self.events[j + 1]
        per = {key: (b[key] - a[key]) / k for key in ("flash_fwd", "flash_bwd_dq",
                                                      "flash_bwd_dkv")}
        return per, (b["t"] - a["t"]) / k, c["t"] - b["t"]

    def tta_peak(self):
        """(peak allocated GiB up to the first generation, GiB held at the
        first video mark): the TTA's own peak, with the weights."""
        g = self.events[self.first("generation")]
        return g["peak"] / 2**30, self.events[0]["held"] / 2**30


def _vp_lane_step(dit, lanes, delta, mask, dev):
    """One batched delta_a step of the folded lanes: each lane's loss and
    delta gradient."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.tta.losses import (
        flow_matching_loss_conditioned,
        fold_lanes,
    )

    V = len(lanes)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    fold = lambda key: fold_lanes([t(lane[key]) for lane in lanes])
    d = t(delta).requires_grad_(True)
    m = torch.from_numpy(mask).to(dev)
    loss = flow_matching_loss_conditioned(
        dit, fold("cond"), fold("target"), fold("emb"), torch.cat([m] * V),
        adapters={"delta_t": d}, sigma=fold("sigma"), noise=fold("noise"), lanes=V)
    (g,) = torch.autograd.grad(loss.sum(), [d])
    return loss.detach().double().cpu(), g.double().cpu()


def vp_agreement_reference() -> dict:
    """The CPU side of ``phase_vp_agreement``: the longcat_demo DiT (seed 5;
    an untouched copy for the card), 2 lanes' inputs, their step."""
    import copy

    import numpy as np

    from longcat_video_tta_tpu_torch.config import longcat_demo
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle

    cfg = longcat_demo()
    cpu_dit = ModelBundle.init_random(cfg, seed=5, device="cpu").dit
    rng = np.random.default_rng(2)
    V, D = VP["lanes"], cfg.dit
    lanes = [dict(cond=rng.standard_normal((1, 16, 2, 8, 16)),
                  target=rng.standard_normal((1, 16, 1, 8, 16)),
                  emb=rng.standard_normal((1, D.text_len, D.text_dim)),
                  sigma=np.array([0.3 + 0.4 * v]),
                  noise=rng.standard_normal((1, 16, 1, 8, 16))) for v in range(V)]
    delta = 0.1 * rng.standard_normal((V, D.adaln_tembed_dim))
    mask = np.ones((1, D.text_len), np.int64)
    return dict(dit=copy.deepcopy(cpu_dit), lanes=lanes, delta=delta, mask=mask,
                step=_vp_lane_step(cpu_dit, lanes, delta, mask, "cpu"))


def phase_vp_agreement(card: str = "cuda", ref=None):
    """One batched delta_a step of 2 lanes (each its own cond, target,
    text, sigma and noise) on the card vs the CPU plain path at
    longcat_demo width (bf16): each lane's loss and delta gradient under
    the step agreement's gates (``ref``: the CPU side, from
    ``vp_agreement_reference``)."""
    ref = ref or vp_agreement_reference()
    loss_c, grad_c = ref["step"]
    loss_g, grad_g = _vp_lane_step(ref["dit"].to(card), ref["lanes"], ref["delta"],
                                   ref["mask"], card)
    ok = True
    for v in range(len(ref["lanes"])):
        rel = float(abs(loss_g[v] - loss_c[v]) / abs(loss_c[v]))
        cos = float(grad_g[v] @ grad_c[v] / (grad_g[v].norm() * grad_c[v].norm()))
        print(f"[vp-agree] longcat_demo batched delta_a step, lane {v}, card vs cpu: loss "
              f"{float(loss_g[v]):.6g} vs {float(loss_c[v]):.6g} (rel {rel:.3g}, max "
              f"{STEP_LOSS_RTOL}); grad cosine {cos:.6f} (min {STEP_GRAD_COS_MIN})")
        ok = ok and rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS_MIN
    if not ok:
        raise AssertionError("card and CPU batched steps disagree")


def _vp_argv(method: str, out_dir: str, card: str, *flags):
    return ["--method", method, "--preset", "longcat_13b", "--synthetic", str(VP["videos"]),
            "--output-dir", out_dir, "--device", card, "--seed", str(VP["seed"]),
            "--height", str(TTA["height"]), "--width", str(TTA["width"]),
            "--num-cond-frames", str(TTA["cond_frames"]),
            "--tta-total-frames", str(TTA["tta_total_frames"]),
            "--num-frames", str(TTA["gen_frames"]), "--steps", str(VP["steps"]),
            "--es-check-every", str(VP["check_every"]), "--es-patience", str(TTA["patience"]),
            "--num-inference-steps", str(VP["inference_steps"]),
            "--guidance-scale", str(TTA["guidance"]), "--save-adapters", *flags]


def _vp_run(fa, tag: str, argv, card: str):
    """The runner under a ``PhaseProbe``; returns (summary, probe, launches)."""
    from longcat_video_tta_tpu_torch.runners import run_tta

    print(f"[vp {tag}] run_tta " + " ".join(argv))
    probe = PhaseProbe(fa, card)
    fa.reset_launches()
    t0 = time.time()
    summary = run_tta.main(argv, on_phase=probe)
    got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches}
    print(f"[vp {tag}] wall {time.time() - t0:.1f} s")
    for i, r in enumerate(summary["results"]):
        print(f"[vp {tag}] video {i}: success={r['success']} train_time={r.get('train_time')} "
              f"s es_check_time={r.get('es_check_time')} s gen_time={r.get('gen_time')} s "
              f"losses={r.get('losses')} adapter_norm={r.get('adapter_norm')} "
              f"best_step={(r.get('early_stopping_info') or {}).get('best_step')} "
              f"vp_steps_executed={r.get('vp_steps_executed')} psnr={r.get('psnr')} "
              f"ssim={r.get('ssim')} lpips={r.get('lpips')}"
              + (f" error={r['error']}" if "error" in r else ""))
    if summary["num_success"] != VP["videos"]:
        raise AssertionError(f"[vp {tag}] {summary['num_success']}/{VP['videos']} videos")
    return summary, probe, got


def _adapter_vector(r):
    """A video's saved adapter as one flat fp64 vector."""
    import torch

    state = torch.load(r["adapter_path"], map_location="cpu")
    return torch.cat([state[k].double().flatten() for k in sorted(state)])


def phase_vp(fa, dit_cfg, tokens_per_frame, card: str = "cuda", agree_ref=None):
    """(a) B1-B3 at the folded shapes against the plain version and SDPA;
    (b) one batched step of 2 lanes, card vs CPU; (c) delta_a at
    LongCat-13.6B width and depth through the runner with --video-parallel 2
    --native-prefetch, and the same 2 videos one after the other: each
    lane's losses, early-stopping record and adapter against its sequential
    run, per-step launches equal to one video's, the group's own peak; (d)
    lora on 8 sites at V 2. ``agree_ref``: (b)'s CPU side, computed here
    when None. Returns (forward cases, backward cases, launches over the
    runs, the run folders and tower files for [tools])."""
    import numpy as np
    import torch

    depth = dit_cfg.depth
    fwd = [check_kernel_case(fa, name, *shape, timed=True, **opts)
           for name, shape, opts in vp_kernel_cases(dit_cfg, tokens_per_frame)]
    (b_self, b_anchor, b_cross) = vp_kernel_cases(dit_cfg, tokens_per_frame)
    bwd = check_bwd_case(fa, b_self[0], *b_self[1], timed=True, **b_self[2])
    bwd += check_bwd_case(fa, "vp_train_cross_dq", *b_cross[1], timed=True, dkv=False,
                          **b_cross[2])
    for c in fwd:
        print("[vp-kernel] " + json.dumps(c))
    for c in bwd:
        print("[vp-bwd-kernel] " + json.dumps(c))
    phase_vp_agreement(card, agree_ref)

    base = os.path.join(RUN_DIR, "vp", "results", "chip_smoke_vp")
    towers = os.path.join(RUN_DIR, "vp", "towers")
    for d in (base, towers):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(towers)
    gen = torch.Generator(device=card).manual_seed(VP["tower_seed"])
    paths = {}
    for name, file, shapes in (("lpips", "lpips_alex.pth", lpips_state_shapes()),
                               ("i3d", "i3d_pytorch.pt", i3d_state_shapes())):
        paths[name] = os.path.join(towers, file)
        torch.save({k: tower_value(k, s, gen, card).cpu() for k, s in shapes.items()},
                   paths[name])
    lpips = ["--lpips-model-path", paths["lpips"]]
    print(f"[vp] geometry: {TTA['height']}x{TTA['width']}, {TTA['tta_total_frames']}-frame "
          f"window, split {tta_split()}; {VP['videos']} videos, {VP['steps']} steps, check "
          f"every {VP['check_every']}, {VP['inference_steps']} denoising steps; full width "
          f"and depth {depth}")
    checks = VP["steps"] // VP["check_every"]
    totals = {}
    out = {}
    for tag, method, flags in (
            ("delta_a", "delta_a", ["--video-parallel", str(VP["lanes"]),
                                    "--native-prefetch", *lpips]),
            ("sequential", "delta_a", lpips),
            ("lora", "lora", ["--video-parallel", str(VP["lanes"]), "--native-prefetch",
                              "--lora-target-ffn", "--no-save-videos"])):
        run_dir = os.path.join(base, tag)
        summary, probe, got = _vp_run(fa, tag, _vp_argv(method, run_dir, card, *flags), card)
        graph = "cross_kv" if method == "lora" else "t_embed"
        one = train_step_launches(graph, depth)
        per, step_s, anchor_s = probe.train_step(VP["steps"])
        peak, held = probe.tta_peak()
        if tag == "sequential":
            expected = {k: VP["videos"] * n for k, n in method_launches(
                graph, depth, steps=VP["steps"], anchors=1 + checks,
                inference_steps=VP["inference_steps"]).items()}
        else:
            expected = vp_launches(graph, depth, lanes=VP["lanes"], steps=VP["steps"],
                                   checks=checks, inference_steps=VP["inference_steps"])
        rows = 1 if tag == "sequential" else VP["lanes"]
        print(f"[vp {tag}] train step {step_s:.3f} s ({rows} row(s)), anchor eval "
              f"{anchor_s:.3f} s ({6 * rows} rows); TTA peak {peak:.2f} GiB "
              f"({peak - held:.2f} above the {held:.2f} GiB held after the weight draw); "
              f"launches per train step {per} (one video's {one}); launches {got} "
              f"(expected {expected})")
        if per != {k: float(n) for k, n in one.items()} or got != expected:
            raise AssertionError(f"[vp {tag}] launches per step {per} (one video's {one}), "
                                 f"total {got} (expected {expected})")
        for r in summary["results"]:
            history = [x for _, x in r["early_stopping_info"]["loss_history"]]
            if not (np.isfinite(r["losses"] + history).all()
                    and len(r["losses"]) == VP["steps"]):
                raise AssertionError(f"[vp {tag}] non-finite or missing losses: {r}")
            scores = [r["psnr"], r["ssim"]] + ([] if tag == "lora" else [r["lpips"]])
            if not np.isfinite(scores).all():
                raise AssertionError(f"[vp {tag}] non-finite metrics: {r}")
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        out[tag] = dict(dir=run_dir, summary=summary, step_s=step_s, anchor_s=anchor_s,
                        peak=peak, held=held)

    vp, seq = out["delta_a"]["summary"], out["sequential"]["summary"]
    for v, (a, b) in enumerate(zip(vp["results"], seq["results"])):
        la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
        rel = np.abs(la - lb) / np.abs(lb)
        ea, eb = a["early_stopping_info"], b["early_stopping_info"]
        va, vb = _adapter_vector(a), _adapter_vector(b)
        na, nb = float(va.norm()), float(vb.norm())
        cos = float(va @ vb / (na * nb)) if na > 0 and nb > 0 else float("nan")
        print(f"[vp] lane {v} vs its sequential run: losses rel {rel.tolist()} (step 0 max "
              f"{VP['loss0_rtol']}, later max {VP['loss_rtol']}); best_step "
              f"{ea['best_step']} vs {eb['best_step']}; adapter norm {na:.6g} vs {nb:.6g}, "
              f"cosine {cos:.6f} (min {VP['cos_min']}); train_time {a['train_time']:.3f} vs "
              f"{b['train_time']:.3f} s, es_check_time {a['es_check_time']:.3f} vs "
              f"{b['es_check_time']:.3f} s; psnr {a['psnr']:.4f} vs {b['psnr']:.4f}")
        if not (rel[0] <= VP["loss0_rtol"] and (rel[1:] <= VP["loss_rtol"]).all()
                and ea["best_step"] == eb["best_step"]
                and (na == nb == 0 or cos >= VP["cos_min"])):
            raise AssertionError(f"[vp] lane {v} disagrees with its sequential run")
    print(f"[vp] group of {VP['lanes']} vs one video: train step {out['delta_a']['step_s']:.3f}"
          f" vs {out['sequential']['step_s']:.3f} s, anchor eval "
          f"{out['delta_a']['anchor_s']:.3f} vs {out['sequential']['anchor_s']:.3f} s, TTA "
          f"peak {out['delta_a']['peak']:.2f} vs {out['sequential']['peak']:.2f} GiB "
          f"(lora group {out['lora']['peak']:.2f} GiB)")
    runs = dict(base=os.path.join(RUN_DIR, "vp"), results=os.path.dirname(base),
                runs={k: v["dir"] for k, v in out.items()}, towers=paths)
    return fwd, bwd, totals, runs


def _flags_argv(out_dir: str, card: str, *flags):
    return ["--method", "delta_a", "--preset", "longcat_demo", "--synthetic", "1",
            "--output-dir", out_dir, "--device", card, "--seed", str(FLAGS["seed"]),
            "--height", str(FLAGS["height"]), "--width", str(FLAGS["width"]),
            "--num-cond-frames", str(FLAGS["cond_frames"]),
            "--tta-total-frames", str(FLAGS["tta_total_frames"]),
            "--num-frames", str(FLAGS["gen_frames"]), "--steps", str(FLAGS["steps"]),
            "--es-check-every", str(FLAGS["check_every"]),
            "--num-inference-steps", str(FLAGS["inference_steps"]),
            "--caption-guard-mode", "off", "--no-save-videos", *flags]


def phase_flags(fa, card: str = "cuda"):
    """The debugging and profiling flags on the card, one longcat_demo video
    each: the default run, --profile-dir (a trace whose kernel events
    include flash_fwd), --debug-nans and --attn-impl xla (the default run's
    losses and anchors within the card-vs-CPU tolerance), and
    --compile-cache-dir on a fresh folder (the three kernel libraries are
    built there). Returns the kernel launches of the runs."""
    import numpy as np

    from longcat_video_tta_tpu_torch.ops import flash_attention
    from longcat_video_tta_tpu_torch.runners import run_tta

    base = os.path.join(RUN_DIR, "flags")
    shutil.rmtree(base, ignore_errors=True)
    cache = os.path.join(base, "kernel_cache")
    runs = {"default": [], "profile": ["--profile-dir", os.path.join(base, "trace")],
            "debug_nans": ["--debug-nans"], "attn_xla": ["--attn-impl", "xla"],
            "cache_dir": ["--compile-cache-dir", cache]}
    totals, rec = {}, {}
    for name, flags in runs.items():
        argv = _flags_argv(os.path.join(base, name), card, *flags)
        fa.reset_launches()
        t0 = time.time()
        s = run_tta.main(argv)
        got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
               "flash_bwd_dkv": fa.bwd_dkv_launches}
        r = s["results"][0]
        anchors = [x for _, x in (r.get("early_stopping_info") or {}).get("loss_history",
                                                                           [])]
        print(f"[flags {name}] run_tta {' '.join(flags)}: success={r['success']} wall "
              f"{time.time() - t0:.1f} s losses={r.get('losses')} anchors={anchors} "
              f"psnr={r.get('psnr')} launches {got}"
              + (f" error={r['error']}" if "error" in r else ""))
        if not r["success"] or not np.isfinite(r["losses"] + anchors + [r["psnr"]]).all():
            raise AssertionError(f"[flags {name}] failed: {r}")
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        rec[name] = (np.asarray(r["losses"] + anchors), got)
    ref = rec["default"][0]
    for name in ("debug_nans", "attn_xla", "cache_dir", "profile"):
        rel = float(np.max(np.abs(rec[name][0] - ref) / np.abs(ref)))
        print(f"[flags {name}] losses and anchors vs the default run: max rel {rel:.3g} "
              f"(max {FLAGS['loss_rtol']})")
        if rel > FLAGS["loss_rtol"]:
            raise AssertionError(f"[flags {name}] disagrees with the default run")
    if rec["attn_xla"][1]["flash_fwd"] or not rec["default"][1]["flash_fwd"]:
        raise AssertionError("[flags] --attn-impl xla launched a kernel, or the default "
                             "run none")
    with open(os.path.join(base, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if "flash_fwd" in e.get("name", "")]
    print(f"[flags profile] trace.json: {len(events)} events, {len(kernels)} kernel events, "
          f"{len(flash)} named flash_fwd ({sum(e.get('dur', 0) for e in flash) / 1e3:.2f} ms)")
    if not flash:
        raise AssertionError("[flags profile] no flash_fwd kernel event in the trace")
    built = sorted(f for f in os.listdir(cache) if f.endswith(".so"))
    print(f"[flags cache_dir] {cache}: {built}; kernel folder after the run "
          f"{os.path.relpath(flash_attention.BUILD_DIR, ROOT)}")
    stems = {os.path.splitext(os.path.basename(s))[0] for s in flash_attention.SOURCES}
    if {f.split("-")[0] for f in built} != stems or \
            flash_attention.BUILD_DIR != flash_attention.DEFAULT_BUILD_DIR:
        raise AssertionError(f"[flags cache_dir] libraries {built}, expected {stems}")
    shutil.rmtree(base, ignore_errors=True)
    return totals


def phase_tools(vp_runs, card: str = "cuda"):
    """The post-processing tools on [vp]'s folders: eval_external on the
    group's saved clips against their ground truth (the runner's GT window
    at the run's geometry as uint8 clips) on the card with [vp]'s LPIPS and
    I3D tower files, held to the runner's metric code on the same clips
    and to the runner's recorded values, with a finite FVD; then
    compare_all, diagnostics status and audit, export_results,
    export_loss_curves and figures (where matplotlib is installed) over the
    runs: each returns and writes its files."""
    import numpy as np

    from longcat_video_tta_tpu_torch.comparisons import compare_all, eval_external
    from longcat_video_tta_tpu_torch.data.video_io import decode_frames, resize_frames
    from longcat_video_tta_tpu_torch.eval.lpips import load_lpips_params, \
        make_lpips_feature_fn
    from longcat_video_tta_tpu_torch.eval.metrics import evaluate_generation_metrics
    from longcat_video_tta_tpu_torch.sweep import diagnostics, export_loss_curves, \
        export_results

    runs, paths = vp_runs["runs"], vp_runs["towers"]
    out = os.path.join(vp_runs["base"], "tools")
    shutil.rmtree(out, ignore_errors=True)
    gt_dir = os.path.join(out, "gt")
    os.makedirs(gt_dir)
    with open(os.path.join(runs["delta_a"], "summary.json")) as f:
        vp = json.load(f)
    gen_dir = os.path.join(runs["delta_a"], "videos")
    for r in vp["results"]:
        n = np.load(r["video_path"], mmap_mode="r").shape[0]
        frames = decode_frames(r["path"], n, vp["config"]["gen_start_frame"])
        np.save(os.path.join(gt_dir, r["video"] + ".npy"),
                resize_frames(frames, TTA["height"], TTA["width"]))
    t0 = time.time()
    ext = eval_external.main(["--gen-dir", gen_dir, "--gt-dir", gt_dir, "--device", card,
                              "--lpips-model-path", paths["lpips"], "--i3d-model-path",
                              paths["i3d"], "--output", os.path.join(out, "external.json")])
    print(f"[tools] eval_external {time.time() - t0:.1f} s: n={ext['n']} psnr={ext['psnr']} "
          f"ssim={ext['ssim']} lpips={ext['lpips']} fvd={ext['fvd']}")
    lp = make_lpips_feature_fn(load_lpips_params(paths["lpips"], card))
    keys = ("psnr", "ssim", "lpips")
    by_clip = {os.path.basename(r["video_path"]): r for r in vp["results"]}
    ok = ext["n"] == VP["videos"] and np.isfinite(ext["fvd"])
    for row in ext["per_video"]:
        r = by_clip[row["video"]]
        gen = np.load(r["video_path"]) / 255.0
        gt = np.load(os.path.join(gt_dir, r["video"] + ".npy")) / 255.0
        code = evaluate_generation_metrics(gen, gt, device=card, lpips_feature_fn=lp)
        d_code = max(abs(row[k] - code[k]) for k in keys)
        d_run = {k: abs(row[k] - r[k]) for k in keys}
        print(f"[tools] {row['video']}: eval_external {[row[k] for k in keys]}; the runner's "
              f"metric code on the saved clip {[code[k] for k in keys]} (max diff "
              f"{d_code:.3g}, max {TOOLS['code_atol']}); the runner's record "
              f"{[r[k] for k in keys]} (diff {d_run}: the clip is saved as uint8)")
        ok = ok and d_code <= TOOLS["code_atol"] and d_run["psnr"] <= TOOLS["psnr_atol"] \
            and d_run["ssim"] <= TOOLS["ssim_atol"] and d_run["lpips"] <= TOOLS["lpips_atol"]
    if not ok:
        raise AssertionError("[tools] eval_external disagrees with the runner")

    table = os.path.join(out, "compare.json")
    rows = compare_all.main([f"{k}={v}/summary.json" for k, v in runs.items()]
                            + [f"external={os.path.join(out, 'external.json')}",
                               "--output", table])
    status = diagnostics.main(["status", "--results-roots", vp_runs["results"]])
    audit = diagnostics.main(["audit", runs["sequential"], runs["delta_a"]])
    all_results = os.path.join(out, "all_results.json")
    curves = os.path.join(out, "loss_curves.json")
    export_results.main(["--results-roots", vp_runs["results"], "--output", all_results])
    export_loss_curves.main(["--results-roots", vp_runs["results"], "--output", curves])
    try:  # figures draws with matplotlib, which the card's machine may lack
        from longcat_video_tta_tpu_torch.sweep import figures
    except ImportError as e:
        print(f"[tools] figures not run: {e} (tests/test_torch_tools.py holds it to the "
              "JAX module on the CPU)")
        made = [all_results, curves]
    else:
        made = figures.main(["--all-results", all_results, "--loss-curves", curves,
                             "--output-dir", os.path.join(out, "figures")])
    print(f"[tools] compare_all rows {[r['label'] for r in rows]}; diagnostics status "
          f"{ {k: len(v) for k, v in status.items()} }; audit shared videos "
          f"{audit['num_shared_videos']}, mean delta psnr {audit['mean_delta_psnr']}; "
          f"figures {[os.path.basename(p) for p in made]}")
    if not (len(rows) == len(runs) + 1 and os.path.exists(table)
            and len(status["complete"]) == len(runs) and audit["num_shared_videos"] ==
            VP["videos"] and made and all(os.path.exists(p) for p in made)):
        raise AssertionError("[tools] a tool returned too little or wrote no file")
    shutil.rmtree(vp_runs["base"], ignore_errors=True)


# [mesh]: context and tensor parallelism and the data mesh, in ranks
# that share the card over gloo (NCCL refuses two ranks on one GPU).
# Times taken this way say nothing about a real mesh: the ranks share
# the card's SMs and memory, and gloo copies every message through host
# memory. The chunk rows time B1-B3 in this process at the ring's chunk
# shapes, with global offsets.
MESH = dict(seed=101, timeout_s=420, loss0_rtol=1e-3, loss_rtol=1e-2, cos_min=0.99,
            psnr_min=30.0, tp_loss_rtol=1e-2, tp_cos_min=0.99, tp_fwd_rel_l2=1e-2,
            # the runner runs: the delta_a window, 3 steps, a check every 3, 4
            # denoising steps; ``depth`` of the 48 blocks (two ranks that
            # each hold the whole DiT share the card's 80 GB; 24 fit. 6 for
            # the script's time limit, which [bench] needs: the ranks' gloo
            # traffic makes this the longest phase, and its gates, each
            # rank's launches and its agreement with one rank, hold block by
            # block)
            depth=6, steps=3, check_every=3, inference_steps=4, videos=2)


def mesh_geometry(dit_cfg, tokens_per_frame):
    """(S train, ncond, S decode queries, S cache) of the delta_a window
    and the serving request at 480 x 832 (its 8 generated frames round up
    to 9: 3 latents, 4680 noise tokens against 3120 cached ones)."""
    from longcat_video_tta_tpu_torch.pipeline.pipeline import round_frames_4k1

    n_cond_lat, n_train_lat, _ = tta_split()
    s_train = (n_cond_lat + n_train_lat) * tokens_per_frame
    cond_lat = (MAIN["cond_frames"] - 1) // 4 + 1
    gen_lat = (round_frames_4k1(MAIN["gen_frames"]) - 1) // 4 + 1
    return (s_train, n_cond_lat * tokens_per_frame, gen_lat * tokens_per_frame,
            cond_lat * tokens_per_frame)


def mesh_ring_cases(dit_cfg, tokens_per_frame, world: int):
    """The ring cases one world of ranks runs: the train self-attention
    (10 920 tokens, a 6240-token prefix), and at 2 ranks also the serving
    decode (B 2: 4680 noise queries against 3120 cached and 4680 fresh
    keys), the decode with a key bound two noise frames in, and the train
    step bucketed to 12 480 tokens with kv_valid 10 920."""
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    s_train, ncond, s_dec, s_cache = mesh_geometry(dit_cfg, tokens_per_frame)
    cases = [dict(name=f"ring_train_p{world}", B=1, H=H, D=D, Sq=s_train, Sk=s_train,
                  ncond=ncond, kv_valid=None, cache=0, bwd=True)]
    if world == 2:
        cases += [
            dict(name="ring_decode_p2", B=2, H=H, D=D, Sq=s_dec, Sk=s_dec, ncond=0,
                 kv_valid=None, cache=s_cache, bwd=False),
            dict(name="ring_decode_kv_p2", B=2, H=H, D=D, Sq=s_dec, Sk=s_dec, ncond=0,
                 kv_valid=s_cache + 2 * tokens_per_frame, cache=s_cache, bwd=False),
            dict(name="ring_bucket_p2", B=1, H=H, D=D, Sq=s_train + 1560, Sk=s_train + 1560,
                 ncond=ncond, kv_valid=s_train, cache=0, bwd=True)]
    return cases


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, argv, out_dir: str, timeout_s: float, extra_env=None):
    """Start ``world`` rank processes of ``argv`` (after the interpreter) on
    this card, as torchrun would (MASTER_ADDR/PORT, WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE), wait for all under one timeout, and
    kill every one that is left. Each rank's output goes to
    ``out_dir/rank{r}.log``. Raises unless every rank exits with 0."""
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True", **(extra_env or {}))
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + "".join(f.readlines()[-40:]))
        raise AssertionError(f"mesh ranks failed: {' '.join(argv[:3])}\n"
                             + "\n".join(tails))


def _ring_inputs(case, seed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    B, H, D = case["B"], case["H"], case["D"]
    shape = lambda S: (B, S, H, D)
    rnd = lambda S: torch.randn(shape(S), generator=g, device=device).to(torch.bfloat16)
    q, k, v, do = rnd(case["Sq"]), rnd(case["Sk"]), rnd(case["Sk"]), rnd(case["Sq"])
    kc = vc = None
    if case["cache"]:
        kc, vc = rnd(case["cache"]), rnd(case["cache"])
    return q, k, v, do, kc, vc


def mesh_ring_worker(case, out_path: str):
    """One rank of a ring case: the ring forward (and backward) of this
    rank's token shard against one B1 (B2, B3) launch over the whole
    sequence and against the plain version, each rank's launches of each
    kernel, and its times. Writes a JSON record to ``out_path``."""
    import torch

    from longcat_video_tta_tpu_torch.config import MeshConfig
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa
    from longcat_video_tta_tpu_torch.parallel import build_mesh, ring_self_attention
    from longcat_video_tta_tpu_torch.parallel.context_attention import shard_tokens

    world = int(os.environ["WORLD_SIZE"])
    mesh = build_mesh(MeshConfig(context=world), device="cuda")
    dev = mesh.device
    q, k, v, do, kc, vc = _ring_inputs(case, MESH["seed"], dev)
    ncond, kv = case["ncond"], case["kv_valid"]
    cache = None if kc is None else (kc, vc)
    kf = k if kc is None else torch.cat([kc, k], 1)
    vf = v if vc is None else torch.cat([vc, v], 1)
    kw = dict(num_cond_tokens=ncond, kv_valid_len=kv)
    # one launch over the whole sequence, and the plain version
    o1, lse1 = fa.flash_attention(q, kf, vf, **kw)
    o_ref, lse_ref = reference(fa, q, kf, vf, ncond, kv)
    sh = lambda x: shard_tokens(x, mesh)
    ql, kl, vl, dol = (sh(x).contiguous() for x in (q, k, v, do))
    cl = None if cache is None else tuple(sh(x).contiguous() for x in cache)
    rec = {"case": case["name"], "rank": mesh.rank, "world": world}
    fa.reset_launches()
    if case["bwd"]:
        ql.requires_grad_(True), kl.requires_grad_(True), vl.requires_grad_(True)
    with torch.enable_grad():
        o, lse = ring_self_attention(ql, kl, vl, mesh, num_cond_tokens=ncond, kv_valid=kv,
                                     cache=cl, return_lse=True)
    torch.cuda.synchronize(dev)
    rec["fwd_launches"] = fa.launches
    rec["vs_single"] = kernel_errors(o.detach(), lse.detach(), sh(o1), sh(lse1), "bfloat16")
    rec["vs_plain"] = kernel_errors(o.detach(), lse.detach(), sh(o_ref), sh(lse_ref),
                                    "bfloat16")
    if case["bwd"]:
        o.backward(dol)
        torch.cuda.synchronize(dev)
        rec["dq_launches"], rec["dkv_launches"] = fa.bwd_dq_launches, fa.bwd_dkv_launches
        delta = (do.float() * o1.float()).sum(-1)
        single = (fa.flash_attention_bwd_dq(q, k, v, do, lse1, delta, **kw),
                  *fa.flash_attention_bwd_dkv(q, k, v, do, lse1, delta, **kw))
        plain = backward_reference(fa, q, k, v, o_ref, lse_ref, do, ncond, kv)
        for name, got, one, ref in zip(("dq", "dk", "dv"), (ql.grad, kl.grad, vl.grad),
                                       single, plain):
            rec[f"{name}_vs_single"] = grad_errors(got, sh(one), "bfloat16")
            rec[f"{name}_vs_plain"] = grad_errors(got, sh(ref), "bfloat16")
        del single, plain
    # times on this rank (the other ranks run beside it on the card)
    ql_, kl_, vl_ = (x.detach() for x in (ql, kl, vl))

    def ring_fwd():
        return ring_self_attention(ql_, kl_, vl_, mesh, num_cond_tokens=ncond, kv_valid=kv,
                                   cache=cl)

    rec["ring_fwd_ms"] = _events_ms(ring_fwd, iters=1)
    rec["single_fwd_ms"] = _events_ms(lambda: fa.flash_attention(q, kf, vf, **kw), iters=1)
    if case["bwd"]:
        def ring_step():
            a, b, c = (x.detach().requires_grad_(True) for x in (ql_, kl_, vl_))
            ring_self_attention(a, b, c, mesh, num_cond_tokens=ncond,
                                kv_valid=kv).backward(dol)

        rec["ring_fwd_bwd_ms"] = _events_ms(ring_step, iters=1)
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    with open(out_path, "w") as f:
        json.dump(rec, f)


def mesh_chunk_rows(fa, dit_cfg, tokens_per_frame):
    """B1-B3 at the ring's chunk shapes in this process, with their global
    offsets: (name, B, H, Sq, Sk, D, q_offset, k_offset, ncond, kv_valid,
    backward too)."""
    H, D = dit_cfg.num_heads, dit_cfg.head_dim
    s_train, ncond, s_dec, s_cache = mesh_geometry(dit_cfg, tokens_per_frame)
    c2, c4 = s_train // 2, s_train // 4
    return [
        ("chunk_p2_cond_x_cond", 1, H, c2, c2, D, 0, 0, ncond, None, True),
        ("chunk_p2_cond_x_straddle", 1, H, c2, c2, D, 0, c2, ncond, None, True),
        ("chunk_p2_straddle_x_straddle", 1, H, c2, c2, D, c2, c2, ncond, None, True),
        ("chunk_p4_cond_x_noise", 1, H, c4, c4, D, 0, 3 * c4, ncond, None, True),
        ("chunk_p4_noise_x_noise", 1, H, c4, c4, D, 3 * c4, 3 * c4, ncond, None, True),
        ("chunk_p4_straddle_x_cond", 1, H, c4, c4, D, 2 * c4, 0, ncond, None, True),
        ("chunk_p2_decode_cache", 2, H, s_dec // 2, s_cache // 2, D, 0, 0, 0, None, False),
        ("chunk_p2_decode_noise", 2, H, s_dec // 2, s_dec // 2, D, 0, s_cache, 0, None,
         False),
        ("tp2_train_self_h16", 1, H // 2, s_train, s_train, D, 0, 0, ncond, None, True),
    ]


def check_chunk_row(fa, row):
    """One chunk row: the B1 chunk launch (and B3, B2) against the plain
    versions at the same offsets, timed beside the plain version, SDPA
    with the same boolean mask, and the bound of the pairs the mask lets
    through. Returns (forward result, backward results)."""
    import torch
    import torch.nn.functional as F

    name, B, H, Sq, Sk, D, qo, ko, ncond, kv, bwd = row
    q, k, v = case_inputs(B, H, Sq, Sk, D, seed=zlib.crc32(name.encode()) % 1000)
    kw = dict(num_cond_tokens=ncond, kv_valid=kv)
    o, lse = fa.flash_chunk_fwd(q, k, v, qo, ko, **kw)
    ref, plain_fwd_ms = _timed_once(lambda: [fa.attention_reference(
        q[:, :, h:h + 4], k[:, :, h:h + 4], v[:, :, h:h + 4], num_cond_tokens=ncond,
        kv_valid_len=kv, q_offset=qo, k_offset=ko) for h in range(0, H, 4)])
    o_ref, lse_ref = (torch.cat(x, dim=2) for x in zip(*ref))
    del ref
    err = kernel_errors(o, lse, o_ref, lse_ref, "bfloat16")
    base = {"case": name, "B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D, "q_offset": qo,
            "k_offset": ko, "ncond": ncond, "kv_valid": kv}
    if not err.pop("ok"):
        raise AssertionError(f"chunk row {name}: {json.dumps({**base, **err})}")
    fwd = {**base, **err}
    fwd["ms"] = _events_ms(lambda: fa.flash_chunk_fwd(q, k, v, qo, ko, **kw), iters=10)
    fwd["plain_ms"] = plain_fwd_ms  # the plain version's run above, once
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = sdpa_mask(Sq, Sk, ncond, kv, qo, ko)
    if mask is not None and not bool(mask.any(-1).all()):
        fwd["library_ms"] = None  # SDPA gives NaN rows where no key is visible
    else:
        fwd["library_ms"] = _events_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=10)
    fwd["bound_ms"], fwd["bound_by"] = _bound_ms(B, H, Sq, Sk, D, ncond, kv, 2, qo, ko)
    out_bwd = []
    if bwd:
        g = torch.Generator(device="cuda").manual_seed(7)
        do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_chunk_dq(q, k, v, do, lse, delta, qo, ko, **kw)
        dk, dv = fa.flash_chunk_dkv(q, k, v, do, lse, delta, qo, ko, **kw)
        refs, plain_ms = _timed_once(lambda: [fa._backward_reference_from_delta(
            q[:, :, h:h + 4], k[:, :, h:h + 4], v[:, :, h:h + 4], do[:, :, h:h + 4],
            lse[:, :, h:h + 4], delta[:, :, h:h + 4], num_cond_tokens=ncond,
            kv_valid_len=kv, q_offset=qo, k_offset=ko) for h in range(0, H, 4)])
        rq, rk, rv = (torch.cat(x, dim=2) for x in zip(*refs))
        del refs
        for kname, outs, rs in (("flash_bwd_dq", (dq,), (rq,)),
                                ("flash_bwd_dkv", (dk, dv), (rk, rv))):
            res = {"kernel": kname, **base}
            for oname, d, d_ref in zip(GRAD_NAMES[kname], outs, rs):
                e = grad_errors(d, d_ref, "bfloat16")
                if not e.pop("ok"):
                    raise AssertionError(f"chunk row {name} {oname}: {json.dumps(e)}")
                res.update({f"{oname}_{key}": val for key, val in e.items()})
            res["max_abs_err"] = max(v_ for key, v_ in res.items()
                                     if key.endswith("_max_abs_err"))
            fn = fa.flash_chunk_dkv if kname == "flash_bwd_dkv" else fa.flash_chunk_dq
            res["ms"] = _events_ms(lambda: fn(q, k, v, do, lse, delta, qo, ko, **kw),
                                   iters=10)
            res["plain_ms"] = None
            res["bound_ms"], res["bound_by"] = _bwd_bound_ms(
                B, H, Sq, Sk, D, ncond, kv, 2, kname == "flash_bwd_dkv", qo, ko)
            out_bwd.append(res)
        del rq, rk, rv
        library_ms = None
        if fwd["library_ms"] is not None:
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
            ot = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            dot = do.transpose(1, 2).contiguous()
            library_ms = _events_ms(lambda: ot.backward(dot, retain_graph=True), iters=3)
        for res in out_bwd:
            res["plain_ms"], res["library_ms"] = plain_ms, library_ms
    return fwd, out_bwd


def check_ring_world(world: int, cases, out_dir: str) -> None:
    """Each rank's record of each ring case of one world: its launches (P
    forward, 2P for the decode's two pieces; P dQ and P dK/dV) and every
    gate against one launch and the plain version."""
    for case in cases:
        pieces = 2 if case["cache"] else 1
        for r in range(world):
            with open(os.path.join(out_dir, f"{case['name']}.rank{r}.json")) as f:
                rec = json.load(f)
            want = {"fwd_launches": world * pieces}
            if case["bwd"]:
                want.update(dq_launches=world, dkv_launches=world)
            got = {key: rec[key] for key in want}
            gates = [rec[g] for g in rec if g.startswith(("vs_", "dq_", "dk_", "dv_"))
                     and isinstance(rec[g], dict)]
            bad = [g for g in gates if not g["ok"]]
            if got != want or bad:
                raise AssertionError(f"ring case {case['name']} rank {r}: launches "
                                     f"{got} (want {want}); {json.dumps(rec)}")
            print(f"[mesh-ring] {json.dumps(rec)}")


def phase_mesh_kernels(fa, dit_cfg, tokens_per_frame):
    """[mesh] (a): the chunk rows in this process, then the ring in 4 ranks
    on the card against one launch over the whole sequence and the plain
    version, with each rank's launches (the 2-rank ring runs in the 2-rank
    world of ``phase_mesh_runs``)."""
    fwd_rows, bwd_rows = [], []
    for row in mesh_chunk_rows(fa, dit_cfg, tokens_per_frame):
        f, b = check_chunk_row(fa, row)
        fwd_rows.append(f)
        bwd_rows += b
        print(f"[mesh-chunk] {json.dumps(f)}")
        for r in b:
            print(f"[mesh-chunk] {json.dumps(r)}")
    out_dir = os.path.join(RUN_DIR, "mesh_ring")
    cases = mesh_ring_cases(dit_cfg, tokens_per_frame, 4)
    t0 = time.time()
    spawn_ranks(4, [os.path.abspath(__file__), "--mesh-worker", "ring",
                    "--mesh-out", out_dir], out_dir, MESH["timeout_s"],
                {"CHIP_SMOKE_CASES": json.dumps(cases)})
    check_ring_world(4, cases, out_dir)
    print(f"[mesh-ring] 4 ranks on one card over gloo: {time.time() - t0:.1f} s")
    return fwd_rows, bwd_rows


def _mesh_argv(out_dir: str, videos: int, *flags):
    return ["--method", "delta_a", "--preset", "longcat_13b", "--synthetic", str(videos),
            "--output-dir", out_dir, "--device", "cuda", "--seed", str(MESH["seed"]),
            "--height", str(TTA["height"]), "--width", str(TTA["width"]),
            "--num-cond-frames", str(TTA["cond_frames"]),
            "--tta-total-frames", str(TTA["tta_total_frames"]),
            "--num-frames", str(TTA["gen_frames"]), "--steps", str(MESH["steps"]),
            "--es-check-every", str(MESH["check_every"]),
            "--es-patience", str(TTA["patience"]),
            "--num-inference-steps", str(MESH["inference_steps"]),
            "--guidance-scale", str(TTA["guidance"]), "--save-adapters",
            "--caption-guard-mode", "off", *flags]  # one synthetic caption: 100% of the set


def mesh_runner(fa, argv, out_json: str):
    """One rank's runner call (or the one-rank reference, in this process)
    at [mesh]'s depth cut: its launches counted from 0, the phase times
    and peak memory of a ``PhaseProbe``, and each generated clip kept as
    .npy beside ``out_json`` (the saved clip is lossy). Writes and returns
    the record."""
    import numpy as np

    from longcat_video_tta_tpu_torch.eval import metrics
    from longcat_video_tta_tpu_torch.runners import run_tta

    rank = int(os.environ.get("RANK", "0"))
    clips = []
    evaluate = metrics.evaluate_generation_metrics

    def keep(gen, gt, **kw):
        path = f"{out_json}.clip{len(clips)}.rank{rank}.npy"
        np.save(path, np.asarray(gen))
        clips.append(path)
        return evaluate(gen, gt, **kw)

    probe = PhaseProbe(fa, "cuda")
    metrics.evaluate_generation_metrics = keep
    t0 = time.time()
    try:
        with preset_depth(MESH["depth"], "longcat_13b"):
            fa.reset_launches()  # the main path starts here
            summary = run_tta.main(argv, on_phase=probe)
            launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
                        "flash_bwd_dkv": fa.bwd_dkv_launches}
    finally:
        metrics.evaluate_generation_metrics = evaluate
    per, step_s, anchor_s = probe.train_step(MESH["steps"])
    peak, held = probe.tta_peak()
    rec = dict(rank=rank, launches=launches, summary=summary, clips=clips, step_s=step_s,
               anchor_s=anchor_s, peak_gib=peak, held_gib=held,
               wall_s=probe.events[-1]["t"] - probe.events[0]["t"], run_s=time.time() - t0)
    with open(f"{out_json}.rank{rank}", "w") as f:
        json.dump(rec, f)
    return rec


def _clip_psnr(a_path: str, b_path: str) -> float:
    import numpy as np

    a, b = (np.load(p).astype(np.float64) for p in (a_path, b_path))
    mse = float(np.mean((a - b) ** 2))
    peak = 1.0 if max(a.max(), b.max()) <= 1.0 else 255.0
    return float("inf") if mse == 0 else 10 * math.log10(peak ** 2 / mse)


def _adapter_cos(a_path: str, b_path: str) -> float:
    import torch

    va, vb = (torch.cat([s[k].double().flatten() for k in sorted(s)])
              for s in (torch.load(p, map_location="cpu") for p in (a_path, b_path)))
    return float(va @ vb / (va.norm() * vb.norm()))


def check_mesh_run(tag, ranks, ref, expected):
    """A mesh run's rank 0 summary against the one-rank run: step-0 loss
    within ``loss0_rtol``, later losses and anchors within ``loss_rtol``,
    the same best step, adapter cosine, the clip within ``psnr_min`` dB of
    the one-rank clip, finite metrics; every rank's launches as
    ``expected`` (one dict, or one per rank)."""
    import numpy as np

    res = ranks[0]["summary"]["results"]
    failed = [r.get("error") for r in res + ref["summary"]["results"] if not r["success"]]
    if failed or len(res) != len(ref["summary"]["results"]):
        raise AssertionError(f"[mesh {tag}] videos failed: {failed}")
    ok_all = True
    for i, (a, b) in enumerate(zip(res, ref["summary"]["results"])):
        la, lb = np.asarray(a["losses"], float), np.asarray(b["losses"], float)
        ha = np.asarray([x for _, x in a["early_stopping_info"]["loss_history"]], float)
        hb = np.asarray([x for _, x in b["early_stopping_info"]["loss_history"]], float)
        rel = lambda x, y: np.abs(x - y) / np.abs(y)
        clip_a = _clip_for(ranks, i)
        psnr = _clip_psnr(clip_a, ref["clips"][i])
        cos = _adapter_cos(a["adapter_path"], b["adapter_path"])
        ok = (a["success"] and len(la) == len(lb) and rel(la[:1], lb[:1]).max() <= MESH["loss0_rtol"]
              and rel(la, lb).max() <= MESH["loss_rtol"] and len(ha) == len(hb)
              and rel(ha, hb).max() <= MESH["loss_rtol"]
              and a["early_stopping_info"]["best_step"] == b["early_stopping_info"]["best_step"]
              and cos >= MESH["cos_min"] and psnr >= MESH["psnr_min"]
              and np.isfinite([a["psnr"], a["ssim"]]).all())
        print(f"[mesh {tag}] video {i}: losses {la.tolist()} vs one rank {lb.tolist()}; "
              f"anchors {ha.tolist()} vs {hb.tolist()}; best step "
              f"{a['early_stopping_info']['best_step']} vs "
              f"{b['early_stopping_info']['best_step']}; adapter cosine {cos:.6f}; clip "
              f"{psnr:.2f} dB from the one-rank clip; psnr {a['psnr']:.4f} ssim "
              f"{a['ssim']:.4f} (one rank {b['psnr']:.4f} {b['ssim']:.4f})")
        ok_all = ok_all and ok
    for r in ranks:
        want = expected[r["rank"]] if isinstance(expected, list) else expected
        print(f"[mesh {tag}] rank {r['rank']} of {len(ranks)} sharing the card over gloo: "
              f"train step {r['step_s']:.3f} s, anchor eval {r['anchor_s']:.3f} s, TTA peak "
              f"{r['peak_gib']:.2f} GiB ({r['held_gib']:.2f} held), wall {r['wall_s']:.1f} s; "
              f"launches {r['launches']} (expected {want})")
        ok_all = ok_all and r["launches"] == want
    print(f"[mesh {tag}] one rank alone: train step {ref['step_s']:.3f} s, anchor eval "
          f"{ref['anchor_s']:.3f} s, TTA peak {ref['peak_gib']:.2f} GiB "
          f"({ref['held_gib']:.2f} held), wall {ref['wall_s']:.1f} s")
    if not ok_all:
        raise AssertionError(f"[mesh {tag}] the mesh run disagrees with one rank")


def _clip_for(ranks, i: int) -> str:
    """The clip of video ``i``: rank 0's when every rank generated every
    video (context, tensor); under a data mesh each rank generated its
    lanes, in rank order."""
    own = ranks[0]["clips"]
    if len(own) == len(ranks[0]["summary"]["results"]):
        return own[i]
    return [p for r in ranks for p in r["clips"]][i]


def phase_mesh_runs(fa, ring_cases=()):
    """[mesh] (b): the runner at LongCat-13.6B width, [mesh]'s depth cut,
    2 ranks sharing the card over gloo: --context-mesh 2 and --tensor-mesh
    2 against the one-rank run of 1 video, --video-parallel 2 --data-mesh 2
    against the one-rank --video-parallel 2 run of 2 videos. The one-rank
    runs go first, in this process; then one 2-rank world runs
    ``ring_cases`` ((a)'s 2-rank ring), (c) the small MMDiT and CogVideoX
    under tensor parallelism when there are ring cases, and the three mesh
    runs, one after the other (the ranks start once). Returns each run's
    launches summed over its ranks (main-path launches)."""
    import gc

    import torch

    base = os.path.join(RUN_DIR, "mesh_runs")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    d = MESH["depth"]
    print(f"[mesh] geometry: {TTA['height']}x{TTA['width']}, {TTA['tta_total_frames']}-frame "
          f"window, split {tta_split()}; {MESH['steps']} steps, check every "
          f"{MESH['check_every']}, {MESH['inference_steps']} denoising steps; full width, "
          f"{d} of 48 blocks; 2 ranks share one card over gloo (no measure of a real mesh)")
    refs = {}
    for tag, videos, flags in (("one", 1, []), ("vp", MESH["videos"],
                                                ["--video-parallel", "2"])):
        out = os.path.join(base, tag)
        refs[tag] = mesh_runner(fa, _mesh_argv(out, videos, *flags), out + ".json")
        gc.collect()
        torch.cuda.empty_cache()
    checks = MESH["steps"] // MESH["check_every"]
    common = dict(steps=MESH["steps"], anchors=1 + checks,
                  inference_steps=MESH["inference_steps"])
    meshes = [("context", "context", 1, ["--context-mesh", "2"], refs["one"]),
              ("tensor", "tensor", 1, ["--tensor-mesh", "2"], refs["one"]),
              ("data", "data", MESH["videos"], ["--video-parallel", "2", "--data-mesh", "2"],
               refs["vp"])]
    runs = [(os.path.join(base, tag) + ".json",
             _mesh_argv(os.path.join(base, tag), videos, *flags))
            for tag, _, videos, flags, _ in meshes]
    ring_dir = os.path.join(RUN_DIR, "mesh_ring")
    t0 = time.time()
    spawn_ranks(2, [os.path.abspath(__file__), "--mesh-worker", "ring",
                    "--mesh-out", ring_dir], os.path.join(base, "logs"),
                MESH["timeout_s"] * (1 + len(runs)),
                {"CHIP_SMOKE_CASES": json.dumps(list(ring_cases)),
                 "CHIP_SMOKE_RUNS": json.dumps(runs)})
    print(f"[mesh] the 2-rank world: {time.time() - t0:.1f} s with the ranks' start")
    if ring_cases:
        check_ring_world(2, ring_cases, ring_dir)
        bad = []
        for r in range(2):
            with open(os.path.join(ring_dir, f"tp_small.rank{r}.json")) as f:
                for rec in json.load(f):
                    print(f"[mesh-tp-small] {json.dumps(rec)}")
                    bad += [] if rec["ok"] else [rec]
        if bad:
            raise AssertionError(f"tensor parallelism disagrees with one rank: {bad}")
    totals = {}
    for (tag, kind, videos, flags, ref), (out_json, _) in zip(meshes, runs):
        ranks = []
        for r in range(2):
            with open(f"{out_json}.rank{r}") as f:
                ranks.append(json.load(f))
            for res in ranks[-1]["summary"]["results"]:
                if not res["success"]:  # the traceback is in the rank's log
                    with open(os.path.join(base, "logs", f"rank{r}.log")) as f:
                        print(f"[mesh {tag}] rank {r} log tail:\n" + "".join(f.readlines()[-60:]))
        expected = (mesh_launches("data", d, 2, lanes=1, checks=checks, **common)
                    if kind == "data" else mesh_launches(kind, d, 2, **common))
        check_mesh_run(tag, ranks, ref, expected)
        print(f"[mesh {tag}] {max(r['run_s'] for r in ranks):.1f} s in the 2-rank world")
        for r in ranks:
            for k, n in r["launches"].items():
                totals[k] = totals.get(k, 0) + n
    return totals


def tp_small_check(cfg, seed: int, mesh):
    """One small backbone under tensor parallelism against the same model
    on this rank alone: the forward (relative L2) and one delta_a step's
    loss and delta gradient. The sharded model is drawn tensor by tensor
    into its shards from the same seed."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.archs import get_arch
    from longcat_video_tta_tpu_torch.config import AdapterConfig
    from longcat_video_tta_tpu_torch.models.weights import init_random
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

    dev = mesh.device
    draw = lambda m: init_random(cfg, dev, torch.Generator(device=dev).manual_seed(seed),
                                 m)[0]
    one, tp = draw(None), draw(mesh)
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    C, D = cfg.vae.z_dim, cfg.dit  # 16 latent channels
    cond, target, noise = t(1, C, 2, 8, 16), t(1, C, 1, 8, 16), t(1, C, 1, 8, 16)
    if cfg.arch == "mmdit":  # noise on the target; CogVideoX noises the whole window
        emb, mask = t(1, 16, D.context_in_dim), t(1, D.vec_in_dim)
        fwd = lambda m: m(t(1, C, 3, 8, 16), torch.full((1,), 0.6, device=dev), emb, mask)
    else:
        emb, mask = t(1, 16, D.text_dim), None
        noise = t(1, C, 3, 8, 16)
        fwd = lambda m: m(t(1, C, 3, 8, 16), torch.full((1,), 600.0, device=dev), emb,
                          t(1, C, 3, 8, 16))
    state = rng.bit_generator.state
    out = []
    for m in (one, tp):
        rng.bit_generator.state = state
        with torch.no_grad():
            y = fwd(m).double()
        scheme = build_scheme(D, AdapterConfig(method="delta_a"))
        leaves = {k: (v + 0.01).requires_grad_(True)
                  for k, v in scheme.init(dev, dit=m).items()}
        fwd_dit, ad = scheme.to_forward(leaves, m)
        loss = get_arch(cfg.arch).loss(fwd_dit, cond, target, emb, mask, adapters=ad,
                                       sigma=torch.full((1,), 0.6, device=dev), noise=noise)
        (g,) = torch.autograd.grad(loss, list(leaves.values()))
        out.append((y, float(loss), g.double().flatten()))
    (y1, l1, g1), (y2, l2, g2) = out
    rel = float((y2 - y1).norm() / y1.norm())
    cos = float(g1 @ g2 / (g1.norm() * g2.norm()))
    return dict(arch=cfg.arch, rank=mesh.rank, fwd_rel_l2=rel, loss_one=l1, loss_tp=l2,
                loss_rel=abs(l2 - l1) / abs(l1), grad_cos=cos,
                ok=(rel <= MESH["tp_fwd_rel_l2"] and abs(l2 - l1) / abs(l1) <= MESH["tp_loss_rtol"]
                    and cos >= MESH["tp_cos_min"]))


def mesh_worker(task: str, out_dir: str) -> int:
    """A rank process of [mesh] (``--mesh-worker``): join the process group
    from torchrun's variables and run ``task``."""
    import torch

    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from longcat_video_tta_tpu_torch.parallel import init_distributed

    assert init_distributed(device="cuda")
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    if task != "ring":
        raise ValueError(f"unknown mesh task {task!r}")
    cases = json.loads(os.environ["CHIP_SMOKE_CASES"])
    for case in cases:
        mesh_ring_worker(case, os.path.join(out_dir, f"{case['name']}.rank{rank}.json"))
    if cases and int(os.environ["WORLD_SIZE"]) == 2:
        # (c): the small MMDiT and CogVideoX under --tensor-mesh 2
        from longcat_video_tta_tpu_torch.config import MeshConfig
        from longcat_video_tta_tpu_torch.parallel import build_mesh

        mesh = build_mesh(MeshConfig(tensor=2), device="cuda")
        recs = [tp_small_check(cfg, 17, mesh)
                for cfg in (opensora_small_config(), cogvideox_small_config())]
        with open(os.path.join(out_dir, f"tp_small.rank{rank}.json"), "w") as f:
            json.dump(recs, f)
    # (b): the runner's meshes, one after the other; each starts once both
    # ranks have let go of the last one's memory
    import gc

    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    for out_json, argv in json.loads(os.environ.get("CHIP_SMOKE_RUNS", "[]")):
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        mesh_runner(fa, argv, out_json)

    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_mesh(fa, dit_cfg, tokens_per_frame):
    """[mesh]: (a) the chunk rows and the ring in 4 ranks; (b) the runner's
    three meshes at 13.6B width in one 2-rank world, which first runs (a)'s
    2-rank ring and (c) the small MMDiT and CogVideoX under tensor
    parallelism. Returns (forward rows, backward rows, the runner runs'
    launches)."""
    fwd_rows, bwd_rows = phase_mesh_kernels(fa, dit_cfg, tokens_per_frame)
    runs = phase_mesh_runs(fa, mesh_ring_cases(dit_cfg, tokens_per_frame, 2))
    return fwd_rows, bwd_rows, runs


# ---------------------------------------------------------------------------
# The science loop: the longcat_demo stack pretrained on the card, its
# checkpoint through --checkpoint-dir, and the demo campaign on it
# ---------------------------------------------------------------------------

# [demo] at longcat_demo's full width (DiT 768, 8 blocks, 6 heads of 128,
# ffn 2048; WAN VAE base 32; the small UMT5) and 192x320 frames: (a) one
# VAE step and one DiT pretraining step at pretraining's own shapes (batch
# 2; a 9-frame clip; 4 cond + 8 target latents, 2880 tokens a row) on the
# card against the CPU (the CPU side runs in a background thread while
# earlier phases use the card); (b) pretrain_demo cut to ``vae_steps`` and
# ``dit_steps`` (batch 2, 4 + 8 latent windows); (c) its checkpoint through
# the runner's loader; (d) run_demo_campaign's rows baseline and full, the
# FULL entry alone of the latter (``run_ids``), on 2 videos each with the
# synthetic towers and the YAMLs' 50 denoising steps
DEMO = dict(seed=111, height=192, width=320, vae_steps=20, dit_steps=80,
            rows="baseline,full", run_ids=("NOTTA", "FULL"), videos=2, learn_ratio=0.5,
            batch=2, cond_lat=4, target_lat=8)
DEMO_GRAPHS = {"none": None, "full": "cross_kv"}  # a row's method -> its train graph


def pretrain_launches(depth: int, dit_steps: int) -> dict:
    """Launches of pretrain_demo: every DiT step is a FullScheme ("cross_kv")
    train step without remat (longcat_demo); the VAE and UMT5 attend in
    plain PyTorch."""
    return {k: dit_steps * n for k, n in train_step_launches("cross_kv", depth, "none").items()}


def demo_row_launches(method: str, results, depth: int, inference_steps: int) -> dict:
    """Launches of one demo-campaign row from its summary's results: per
    video its train steps (``losses``) and anchor evals (the early
    stopper's ``total_checks``; none under --es-disable), then one
    generation (``method_launches`` without remat). The counts follow
    this run's data: the early stopper decides how many steps run."""
    graph = DEMO_GRAPHS[method]
    out = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for r in results:
        es = r.get("early_stopping_info") or {}
        got = method_launches(graph or "t_embed", depth,
                              steps=len(r.get("losses", [])) if graph else 0,
                              anchors=es.get("total_checks", 0),
                              inference_steps=inference_steps, policy="none")
        for k in out:
            out[k] += got[k]
    return out


def _loss_grad_of(module, loss_of):
    """(loss, the gradient over every parameter of ``module`` as one
    float64 CPU vector) of ``loss_of(module with those tensors)``."""
    import torch

    from longcat_video_tta_tpu_torch.tta.adapters import with_tensors

    leaves = {k: p.detach().requires_grad_(True) for k, p in module.named_parameters()}
    with torch.enable_grad():
        loss = loss_of(with_tensors(module, leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).double().flatten().cpu()
                      for p, g in zip(leaves.values(), grads)])
    return float(loss.detach()), flat


def demo_step_reference() -> dict:
    """[demo] (a)'s CPU side: longcat_demo drawn on the CPU, one VAE step's
    inputs (a batch of 9-frame distribution-A clips and the KL draw) and
    one DiT pretraining step's (4 cond + 8 target latents, the first
    caption, sigma and noise), each at pretraining's batch, and the loss
    and gradient of each on the CPU (with their seconds)."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.config import longcat_demo
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
    from longcat_video_tta_tpu_torch.scripts import pretrain_demo as pd
    from longcat_video_tta_tpu_torch.tta.losses import draw_sigma_noise

    cfg = longcat_demo()
    B, H, W = DEMO["batch"], DEMO["height"], DEMO["width"]
    cpu = ModelBundle.init_random(cfg, seed=DEMO["seed"], device="cpu")
    rng = np.random.RandomState(DEMO["seed"])
    x = pd.make_clip_gen(2 * cfg.vae.temporal_factor + 1, H, W, "cpu")(*pd.draw_params(rng, B))
    g = torch.Generator().manual_seed(DEMO["seed"])
    kl_noise = torch.randn(pd.latent_shape(cfg.vae, x.shape), generator=g)
    lat = (B, cfg.vae.z_dim, 0, H // cfg.vae.spatial_factor, W // cfg.vae.spatial_factor)
    cond = torch.randn(lat[:2] + (DEMO["cond_lat"],) + lat[3:], generator=g)
    tgt = torch.randn(lat[:2] + (DEMO["target_lat"],) + lat[3:], generator=g)
    sigma, noise = draw_sigma_noise(tgt, g)
    with torch.no_grad():
        emb, mask = cpu.encode_prompt(pd.CAPTIONS[0])
    emb = emb.expand((B,) + tuple(emb.shape[1:])).contiguous()
    mask = mask.expand((B,) + tuple(mask.shape[1:])).contiguous()
    steps = {"vae": (cpu.vae, (x, kl_noise)),
             "dit": (cpu.dit, (cond, tgt, emb, mask, sigma, noise))}
    out = {"steps": steps}
    for name, (module, args) in steps.items():
        t0 = time.time()
        out[name] = _loss_grad_of(module, lambda m: DEMO_LOSSES[name](m, *args))
        out[name + "_s"] = time.time() - t0
    return out


def _demo_vae_loss(m, x, n):
    from longcat_video_tta_tpu_torch.scripts.pretrain_demo import vae_loss

    return vae_loss(m, x, n)[0]


def _demo_dit_loss(m, c, t, e, k, s, n):
    from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

    return flow_matching_loss_conditioned(m, c, t, e, k, sigma=s, noise=n)


DEMO_LOSSES = {"vae": _demo_vae_loss, "dit": _demo_dit_loss}


def start_background(name: str, fn):
    """Start ``fn()`` in a background thread on half the host's cores (a
    CPU side of a card-vs-CPU check, computed while the card phases that
    run meanwhile leave the host idle). Returns a function that waits for
    it and returns its result, or raises its error."""
    import threading

    import torch

    box = {}
    threads = torch.get_num_threads()

    def work():
        torch.set_num_threads(max(1, threads // 2))
        try:
            box["out"] = fn()
        except BaseException as e:  # raised where the result is read
            box["err"] = e
        finally:
            torch.set_num_threads(threads)

    thread = threading.Thread(target=work, name=name, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return result


def start_demo_reference():
    """``demo_step_reference`` in the background (at pretraining's shapes
    its CPU side takes minutes)."""
    return start_background("demo-cpu-reference", demo_step_reference)


def phase_demo_step_agreement(ref: dict, card: str = "cuda"):
    """[demo] (a): one VAE step's loss and gradient and one DiT pretraining
    step's (``FullScheme``: every DiT parameter) on ``card`` against the
    CPU's in ``ref`` (``demo_step_reference``), on the same weights (copied
    from the CPU) and the same draws; the step agreement's gates."""
    import copy

    out = {}
    for name, (module, args) in ref["steps"].items():
        loss_c, grad_c = ref[name]
        on_card = copy.deepcopy(module).to(card)
        t0 = time.time()
        loss_g, grad_g = _loss_grad_of(on_card, lambda m: DEMO_LOSSES[name](
            m, *(a.to(card) for a in args)))
        card_s = time.time() - t0
        del on_card
        rel = abs(loss_g - loss_c) / abs(loss_c)
        cos = float((grad_g @ grad_c) / (grad_g.norm() * grad_c.norm()))
        shapes = [tuple(a.shape) for a in args[:2]]
        print(f"[demo] {name} step card vs cpu, inputs {shapes}: loss {loss_g:.6g} vs "
              f"{loss_c:.6g} (rel {rel:.3g}, max {STEP_LOSS_RTOL}); grad cosine {cos:.6f} "
              f"(min {STEP_GRAD_COS_MIN}) over {grad_c.numel()} parameters; |grad| "
              f"{float(grad_c.norm()):.4g}; cpu {ref[name + '_s']:.1f} s (in the "
              f"background), card {card_s:.1f} s")
        if not (rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS_MIN):
            raise AssertionError(f"[demo] card and CPU {name} steps disagree")
        out[name] = dict(loss_rel=rel, grad_cos=cos)
    return out


def phase_demo(fa, card: str = "cuda", reference=None):
    """[demo]: (a) the step agreement (``reference``: what
    ``start_demo_reference`` returned; started here when None); (b)
    pretrain_demo on the card, cut
    to DEMO's steps, gated on learning (the last logged recon MSE and flow
    loss each at most ``learn_ratio`` of step 0's) with its B1-B3 launches
    against ``pretrain_launches``; (c) the written checkpoint loaded as
    ``run_tta --checkpoint-dir`` loads it, equal to the trained modules
    tensor for tensor; (d) run_demo_campaign on it (rows baseline and full,
    the sweep entries ``DEMO["run_ids"]``, 2 videos each): every row ok,
    every metric finite, launches against ``demo_row_launches``. Returns
    the launches of (b) + (d)."""
    import numpy as np
    import torch

    from longcat_video_tta_tpu_torch.eval.vbench import VBENCH_DIMENSIONS
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
    from longcat_video_tta_tpu_torch.scripts import pretrain_demo, run_demo_campaign

    reference = reference or start_demo_reference()
    base = os.path.join(RUN_DIR, "demo")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    try:
        t0 = time.time()
        ref = reference()
        wait_s = time.time() - t0
        phase_demo_step_agreement(ref, card)
        del ref
        print(f"[time] demo step agreement {time.time() - t0:.1f} s ({wait_s:.1f} s of it "
              f"waiting for the CPU side)")

        ckpt = os.path.join(base, "ckpt")
        trained = {}
        count = lambda: {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
                         "flash_bwd_dkv": fa.bwd_dkv_launches}
        fa.reset_launches()
        if card == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        hist = pretrain_demo.main(
            ["--out-dir", ckpt, "--vae-steps", str(DEMO["vae_steps"]),
             "--dit-steps", str(DEMO["dit_steps"]), "--height", str(DEMO["height"]),
             "--width", str(DEMO["width"]), "--seed", str(DEMO["seed"]), "--device", card],
            on_phase=lambda name, bundle: trained.update(bundle=bundle))
        pre_s = time.time() - t0
        pre = count()
        bundle = trained["bundle"]
        depth = bundle.cfg.dit.depth
        want = pretrain_launches(depth, DEMO["dit_steps"])
        ratios = {}
        for phase, key in (("vae", "mse"), ("dit", "loss")):
            h = [e for e in hist if e["phase"] == phase]
            ratios[phase] = h[-1][key] / h[0][key]
            print(f"[demo] pretrain {phase}: {[(e['step'], round(e[key], 5), e['wall_s']) for e in h]}; "
                  f"last / first {ratios[phase]:.4f} (max {DEMO['learn_ratio']})")
        peak = torch.cuda.max_memory_allocated() / 2**30 if card == "cuda" else 0.0
        print(f"[demo] pretrain {pre_s:.1f} s (VAE {DEMO['vae_steps']}, DiT {DEMO['dit_steps']} "
              f"steps, batch 2, {DEMO['height']}x{DEMO['width']}); launches {pre} (expected "
              f"{want}); max_memory_allocated {peak:.2f} GiB")
        if not all(np.isfinite(e.get("mse", e.get("loss"))) for e in hist):
            raise AssertionError(f"[demo] non-finite pretraining loss: {hist}")
        if any(r > DEMO["learn_ratio"] for r in ratios.values()):
            raise AssertionError(f"[demo] pretraining did not learn: {ratios}")
        if pre != want:
            raise AssertionError(f"[demo] pretrain launches {pre}, expected {want}")

        t0 = time.time()
        loaded = ModelBundle.from_checkpoint_dir(bundle.cfg, ckpt, device=card)
        n_equal = 0
        for part in ("dit", "vae", "text"):
            a = dict(getattr(bundle, part).named_parameters())
            b = dict(getattr(loaded, part).named_parameters())
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            if set(a) != set(b) or bad:
                raise AssertionError(f"[demo] checkpoint {part}: {bad[:5]} differ")
            n_equal += len(a)
        if (loaded.cfg.vae.latents_mean != bundle.cfg.vae.latents_mean
                or loaded.cfg.vae.latents_std != bundle.cfg.vae.latents_std):
            raise AssertionError("[demo] checkpoint: the latent statistics differ")
        print(f"[demo] checkpoint: {n_equal} tensors equal to the trained modules, latent "
              f"statistics equal; loaded in {time.time() - t0:.1f} s")
        del trained, bundle, loaded

        out = os.path.join(base, "campaign")
        towers = os.path.join(base, "towers")
        fa.reset_launches()
        t0 = time.time()
        rc = run_demo_campaign.main(["--output-base", out, "--rows", DEMO["rows"],
                                     "--max-videos", str(DEMO["videos"]),
                                     "--towers-dir", towers, "--ckpt-dir", ckpt,
                                     "--device", card], run_ids=DEMO["run_ids"])
        camp_s = time.time() - t0
        got = count()
        with open(os.path.join(out, "sweep_campaign_demo.json")) as f:
            record = json.load(f)
        want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        for row in record:
            with open(os.path.join(row["output_dir"], "summary.json")) as f:
                summary = json.load(f)
            with open(os.path.join(row["output_dir"], "config.json")) as f:
                steps = json.load(f)["num_inference_steps"]
            res = summary["results"]
            row_want = demo_row_launches(row["method"], res, depth, steps)
            for k in want:
                want[k] += row_want[k]
            metrics = [r.get(m, np.nan) for r in res for m in ("psnr", "ssim", "lpips")]
            online = summary.get("online_eval", {})
            vb = online.get("vbench", {}).get("results", {})
            metrics += [online.get("fvd", np.nan), online.get("fid", np.nan)] + [
                vb.get(d, np.nan) for d in VBENCH_DIMENSIONS]
            print(f"[demo] row {row['run_id']}: {row['status']} in "
                  f"{60 * row.get('wall_minutes', float('nan')):.1f} s; videos "
                  f"{summary['num_success']}/{summary['num_videos']}; psnr "
                  f"{[round(r.get('psnr', np.nan), 4) for r in res]} ssim "
                  f"{[round(r.get('ssim', np.nan), 4) for r in res]} lpips "
                  f"{[round(r.get('lpips', np.nan), 4) for r in res]}; train_time "
                  f"{[round(r.get('train_time', 0.0), 2) for r in res]} s gen_time "
                  f"{[round(r.get('gen_time', 0.0), 2) for r in res]} s steps "
                  f"{[len(r.get('losses', [])) for r in res]}; fvd {online.get('fvd')} fid "
                  f"{online.get('fid')} vbench {vb}; launches expected {row_want}")
            if row["status"] != "ok" or summary["num_success"] != len(res) or not res:
                raise AssertionError(f"[demo] row {row['run_id']}: {row['status']}")
            if not np.isfinite(metrics).all():
                raise AssertionError(f"[demo] row {row['run_id']}: a metric is not finite: "
                                     f"{metrics}")
        print(f"[demo] run_demo_campaign rc {rc} in {camp_s:.1f} s; launches {got} "
              f"(expected {want})")
        with open(os.path.join(out, "timing_table.md")) as f:
            print("[demo] " + f.read().replace("\n", "\n[demo] ").rstrip())
        if rc != 0 or [r["run_id"] for r in record] != list(DEMO["run_ids"]):
            raise AssertionError(f"[demo] run_demo_campaign rc {rc}, rows {record}")
        if got != want:
            raise AssertionError(f"[demo] campaign launches {got}, expected {want}")
        return {k: pre[k] + got[k] for k in got}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def print_build(fa):
    spills = []
    for path, log, seconds in fa.build_libraries():
        print(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"[build] {line.split(chr(39))[1]}")
            if any(w in line for w in ("registers", "spill", "smem", "wgmma", "warpgroup",
                                       "setmaxnreg", "arning")):
                print(f"[build] {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(line.strip())
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="drive the port on one NVIDIA GPU")
    ap.add_argument("--only", default="",
                    help="development: run the build and these comma-separated phases "
                         "(checkpoint, remat, bucket, eval, kernel, bwd, qknorm, opensora, "
                         "cogvideox, t2v, vbench, vp, flags, tools, mesh, demo, longhorizon, "
                         "bench; tools runs after vp) "
                         "and print no result")
    ap.add_argument("--mesh-worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default="", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.mesh_worker:  # a rank process of [mesh]
        return mesh_worker(opts.mesh_worker, opts.mesh_out)
    only = [x for x in opts.only.split(",") if x]
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
    from longcat_video_tta_tpu_torch.ops import qk_norm as qn

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
        import gc

        t0 = time.time()
        out = fn(*args)
        # a runner's bundle can sit in a reference cycle: free it before
        # the next phase measures its peak (LongCat full after norm_tune
        # ran out of memory with the 13.6B bundle still held)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] {name} {time.time() - t0:.1f} s")
        return out

    # the CPU sides of the small-input and step agreements, computed while
    # the kernels build and the kernel phases run
    agree_refs = None if only else start_background(
        "agreement-cpu-references",
        lambda: (small_agreement_reference(), step_agreement_reference()))
    timed_phase("build", print_build, fa)
    cfg = longcat_13b()
    sf = cfg.vae.spatial_factor * cfg.dit.patch_size[1]
    tokens_per_frame = (MAIN["height"] // sf) * (MAIN["width"] // sf)
    import dataclasses

    cut = dataclasses.replace(cfg.dit, depth=CUT_DEPTH)
    if only:  # a development run of the named phases alone: no result lines
        phases = {"checkpoint": (at_cut_depth(phase_checkpoint_path), fa),
                  "remat": (phase_remat_path, fa),
                  "bucket": (phase_bucket_path, fa),
                  "eval": (at_cut_depth(phase_eval), fa, CUT_DEPTH, smi),
                  "kernel": (phase_kernel_checks, fa, cfg.dit, tokens_per_frame),
                  "bwd": (phase_bwd_kernel_checks, fa, cfg.dit, tokens_per_frame),
                  "qknorm": (phase_qk_norm_checks, qn, cfg.dit, tokens_per_frame),
                  "opensora": (phase_opensora, fa), "cogvideox": (phase_cogvideox, fa),
                  "t2v": (at_cut_depth(phase_t2v), fa, cut, tokens_per_frame),
                  "vbench": (at_cut_depth(phase_vbench), fa, bsa, CUT_DEPTH, smi),
                  "vp": (at_cut_depth(phase_vp), fa, cut, tokens_per_frame),
                  "flags": (phase_flags, fa),
                  "longhorizon": (phase_longhorizon, fa, bsa),
                  "bench": (phase_bench, fa, bsa),
                  "mesh": (phase_mesh, fa, cfg.dit, tokens_per_frame),
                  "demo": (phase_demo, fa, "cuda",
                           start_demo_reference() if "demo" in only else None),
                  "mesh_runs": (phase_mesh_runs, fa)}
        done = {}
        for name in only:
            if name == "tools":  # on [vp]'s run folders
                timed_phase(name, phase_tools, done["vp"][3])
                continue
            done[name] = timed_phase(name, *phases[name])
        print(f"[time] all phases {time.time() - t_start:.1f} s")
        return 0
    cases = timed_phase("kernel check", phase_kernel_checks, fa, cfg.dit, tokens_per_frame)
    bwd_cases = timed_phase("backward kernel check", phase_bwd_kernel_checks, fa, cfg.dit,
                            tokens_per_frame)
    bsa_cases, sum_cases = timed_phase("bsa kernel check", phase_bsa_kernel_checks, fa,
                                       bsa, cfg.dit, tokens_per_frame)
    timed_phase("qk prologue check", phase_qk_norm_checks, qn, cfg.dit, tokens_per_frame)
    t0 = time.time()
    small_ref, step_ref = agree_refs()
    print(f"[time] agreement CPU sides: {time.time() - t0:.1f} s of waiting")
    timed_phase("small-input agreement", phase_small_agreement, small_ref)
    timed_phase("step agreement", phase_step_agreement, step_ref)
    timed_phase("scheme step agreement", phase_scheme_step_agreement, step_ref)
    del small_ref, step_ref
    # the CPU sides of [opensora]'s, [cogvideox]'s and [vp]'s agreements and
    # of [demo] (a), in one thread, computed while the card phases before
    # them run
    later_refs = start_background("later-cpu-references", lambda: dict(
        opensora=opensora_agreement_reference(), cogvideox=cogvideox_agreement_reference(),
        vp=vp_agreement_reference(), demo=demo_step_reference()))
    lh_fwd, lh_bsa, lh_sums, lh_run = timed_phase("longhorizon", phase_longhorizon, fa, bsa)
    bench_fwd, bench_bwd, bench_bsa, bench_sums, bench_run = timed_phase("bench", phase_bench,
                                                                         fa, bsa)
    serving_launches, serving_gen = timed_phase("main path", phase_main_path, fa,
                                                cfg.dit.depth)
    tta = timed_phase("delta_a path", phase_tta_path, fa, cfg.dit.depth)
    levers = {}
    for run in LEVER_RUNS:
        levers[run], gen_times = timed_phase(f"lever run {run}", at_cut_depth(phase_lever_path),
                                             fa, bsa, run, CUT_DEPTH)
        print(f"[lever {run}] gen_time per request {gen_times} s; dense serving path "
              f"(5 cond, 8 generated frames, 4 steps) {[g for g, _ in serving_gen]} s")
    methods = {m: timed_phase(f"method run {m}", phase_method_path, fa, m)
               for m in METHOD_RUNS}
    ckpt_launches = timed_phase("checkpoint path", at_cut_depth(phase_checkpoint_path), fa)
    _, remat_run = timed_phase("remat path", phase_remat_path, fa)
    bucket_run = timed_phase("bucket path", phase_bucket_path, fa)
    _, eval_run = timed_phase("eval", at_cut_depth(phase_eval), fa, CUT_DEPTH, smi)
    t0 = time.time()
    later_refs()
    print(f"[time] later agreements' CPU sides: {time.time() - t0:.1f} s of waiting")
    os_fwd, os_bwd, os_run = timed_phase("opensora", phase_opensora, fa,
                                         later_refs().pop("opensora"))
    cv_fwd, cv_bwd, cv_run = timed_phase("cogvideox", phase_cogvideox, fa,
                                         later_refs().pop("cogvideox"))
    t2v_cases, t2v_fwd, t2v_gen = timed_phase("t2v", at_cut_depth(phase_t2v), fa, cut,
                                              tokens_per_frame)
    print(f"[t2v] gen_time per request {t2v_gen} s")
    _, sweep_run = timed_phase("vbench", at_cut_depth(phase_vbench), fa, bsa, CUT_DEPTH, smi)
    vp_fwd, vp_bwd, vp_run, vp_runs = timed_phase("vp", at_cut_depth(phase_vp), fa, cut,
                                                  tokens_per_frame, "cuda",
                                                  later_refs().pop("vp"))
    flags_run = timed_phase("flags", phase_flags, fa)
    timed_phase("tools", phase_tools, vp_runs)
    mesh_fwd, mesh_bwd, mesh_run = timed_phase("mesh", phase_mesh, fa, cfg.dit,
                                               tokens_per_frame)
    demo_run = timed_phase("demo", phase_demo, fa, "cuda", lambda: later_refs()["demo"])
    cases += os_fwd + cv_fwd + t2v_cases + vp_fwd + mesh_fwd + lh_fwd + bench_fwd
    bsa_cases += lh_bsa + bench_bsa
    sum_cases += lh_sums + bench_sums
    bwd_cases += os_bwd + cv_bwd + vp_bwd + mesh_bwd + bench_bwd
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
    # the sweep phase's launches: its row's TTA and its BSA re-evaluation;
    # [longhorizon]'s decodes; [bench]'s decodes and train steps
    lever_sum = lambda name: (sum(levers[run][name] for run in levers)
                              + sweep_run.get(name, 0) + lh_run[name] + bench_run[name])
    train_sum = lambda name: (tta[name] + sum(m[name] for m in methods.values())
                              + remat_run[name] + bucket_run[name] + eval_run[name]
                              + os_run[name] + cv_run[name] + vp_run[name]
                              + flags_run[name] + mesh_run[name] + demo_run[name])
    kernels = [
        entry("flash_fwd", "flash_fwd.cu", "flash_attention.py:133",
              serving_launches + ckpt_launches + t2v_fwd + train_sum("flash_fwd")
              + lever_sum("flash_fwd"), cases),
        entry("flash_bwd_dq", "flash_bwd.cu", "flash_attention.py:327",
              train_sum("flash_bwd_dq") + sweep_run["flash_bwd_dq"]
              + bench_run["flash_bwd_dq"],
              by_kernel("flash_bwd_dq")),
        entry("flash_bwd_dkv", "flash_bwd.cu", "flash_attention.py:261",
              train_sum("flash_bwd_dkv") + sweep_run["flash_bwd_dkv"]
              + bench_run["flash_bwd_dkv"],
              by_kernel("flash_bwd_dkv")),
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
