"""The port's ``scripts/bench`` (the root bench.py's two hot loops on one
card) against the JAX calls the root bench.py makes, on longcat_tiny (the
same DiT weights through models/weights.py, fp32 on the CPU, where the port
runs its plain versions and JAX its Pallas kernels in interpret mode), and
the script's accounting, output, failure and launch rules.

Weights: init_dit's draw with its matrices scaled by 2.5, as
test_torch_longhorizon.py scales them (at init_dit's 0.02 the levers move
tiny latents by less than the tolerances). Geometry: latents 6 x 10 (15
tokens a latent frame), the reference's 4-latent TTA window and 4 cond + 8
generated latents, BSA blocks of 8: 23 key blocks, of which keep 0.35
takes the forced set's 9.

Tolerances (those of the existing tests of the same functions):
- train steps (test_torch_tta.py): losses 1e-5 relative, trained tensors
  1e-4 relative / 1e-6 absolute; the batched chunk
  (test_torch_video_parallel.py): losses 1e-4 relative, tensors as above;
- continuations (test_torch_decode_levers.py, test_torch_longhorizon.py):
  dense and 16-bit BSA 1e-4 abs / 1e-4 rel, W8A8 forms 2e-3 abs.
"""

import ast
import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu import config as jconfig
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.ops.quant import quantize_dit_blocks_int8 as jax_quantize
from longcat_video_tta_tpu.pipeline import sampler as jsampler
from longcat_video_tta_tpu.tta.adapters import build_scheme as jax_build_scheme
from longcat_video_tta_tpu.tta.engine import build_optimizer as jax_build_optimizer
from longcat_video_tta_tpu.tta.engine import make_batched_train_chunk, make_train_step
from longcat_video_tta_tpu.tta.split import split_tta_latents as jax_split
from longcat_video_tta_tpu_torch.config import (
    AdapterConfig,
    BSAConfig,
    longcat_bench,
    longcat_bench_3b,
    longcat_tiny,
)
from longcat_video_tta_tpu_torch.models.weights import (
    load_dit_from_numpy,
    train_params_from_numpy,
)
from longcat_video_tta_tpu_torch.ops import bsa
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.scripts import bench
from longcat_video_tta_tpu_torch.scripts import measure_longhorizon as mlh
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "bench.py")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=0)
JCFG, TCFG = jconfig.longcat_tiny(), longcat_tiny()
GEO = dict(lat_h=6, lat_w=10, block_q=8, block_k=8)
GEN_STEPS = 2
WEIGHT_SCALE = 2.5
# the tiny run of every section: longcat_bench's remat policy on the tiny
# DiT, scale 2 at 3 blocks under full remat, the flagship block's slope to
# 48 blocks
TINY = dataclasses.replace(TCFG, dit=dataclasses.replace(TCFG.dit, remat=True,
                                                         remat_policy="dots_attn"))
TINY2 = dataclasses.replace(TCFG, dit=dataclasses.replace(TCFG.dit, depth=3, remat=True,
                                                          remat_policy="full"))
TINY_FLAGSHIP = dataclasses.replace(TCFG.dit, depth=48, remat=True, remat_policy="full")
TINY_COUNTS = dict(steps=1, gen_steps=GEN_STEPS, vp_lanes=2, vp_steps=2, scale2_steps=1,
                   scale2_gen_steps=2, scale3_steps=1)
CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
SCRIPT_COUNTS = dict(bench.COUNTS)  # the script's own (tiny_main replaces them)


@pytest.fixture(scope="module")
def weights():
    """(JAX's tree, its W8A8 copy, the port's DiT of the same tree)."""
    def init(key):
        params = jdit.init_dit(key, JCFG.dit, zero_init=False)
        return jax.tree.map(lambda a: a * WEIGHT_SCALE if a.ndim >= 2 else a, params)

    params = jax.jit(init)(jax.random.PRNGKey(0))
    return (params, jax.jit(jax_quantize)(params),
            load_dit_from_numpy(jax.tree.map(np.asarray, params), TCFG.dit, "cpu"))


@pytest.fixture(scope="module")
def draws():
    """text [1, 16, 48], the TTA window [1, 16, 4, 6, 10], cond [1, 16, 4,
    6, 10], two initial noises [1, 16, 8, 6, 10]."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    lat = (GEO["lat_h"], GEO["lat_w"])
    return dict(text=f32(1, TCFG.dit.text_len, TCFG.dit.text_dim),
                window=f32(1, 16, bench.WINDOW_LATENTS, *lat),
                cond=f32(1, 16, bench.COND_LATENTS, *lat),
                noises=[f32(1, 16, bench.GEN_LATENTS, *lat) for _ in range(2)])


@pytest.fixture(scope="module")
def inp(weights, draws):
    return bench.setup(TCFG, "cpu", dit=weights[2], text=torch.from_numpy(draws["text"]),
                       window=torch.from_numpy(draws["window"]),
                       cond=torch.from_numpy(draws["cond"]), **GEO)


@functools.partial(jax.jit, static_argnums=1)
def _jax_sigma_noise(key, shape):
    """The sigma and noise the conditioned loss draws from ``key``
    (tta/losses.py:152-154)."""
    k_sig, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), minval=0.001, maxval=1.0)
    return sigma, jax.random.normal(k_noise, shape, jnp.float32)


def _jax_draws(key, shape):
    return tuple(torch.from_numpy(np.array(x)) for x in _jax_sigma_noise(key, shape))


def _jax_window(draws):
    """bench.py:56's split of the window, and the text and mask."""
    c, tr, _ = jax_split(jnp.asarray(draws["window"]), 2, 0.25)
    text = jnp.asarray(draws["text"])
    return c, tr, text, jnp.ones((1, text.shape[1]), jnp.int32)


def _jax_steps(params, acfg, init_key, keys, draws):
    """bench.py:58-75 / :166-181: make_train_step at lr 5e-3 from
    ``scheme.init(init_key)``, one step per key -> (initial tensors,
    losses, final tensors)."""
    scheme = jax_build_scheme(JCFG.dit, acfg)
    tx = jax_build_optimizer(jconfig.OptimConfig(lr=5e-3))
    step = make_train_step(scheme, JCFG.dit, tx)
    tp0 = scheme.init(init_key, base_params=params)
    tp, state, losses = tp0, tx.init(tp0), []
    for key in keys:
        tp, state, loss = step(tp, state, params, *_jax_window(draws), key)
        losses.append(float(loss))
    return tp0, np.asarray(losses), tp


@pytest.mark.parametrize("method", ["delta_a", "lora"])
def test_train_sections_match_jax_make_train_step(weights, draws, inp, method):
    """delta_a (bench.py:58-75) and LoRA r1 / alpha 2 (:166-181): the
    warm-up and one timed step on JAX's draws from the reference's keys
    (99, 100 and 200, 201), the LoRA init JAX's from key 6."""
    params = weights[0]
    if method == "delta_a":
        acfg, init, first = dict(method="delta_a"), 5, 99
    else:
        acfg, init, first = dict(method="lora", lora_rank=1, lora_alpha=2.0), 6, 200
    keys = [jax.random.PRNGKey(first + i) for i in range(2)]
    tp0, losses_j, tp_j = _jax_steps(params, jconfig.AdapterConfig(**acfg),
                                     jax.random.PRNGKey(init), keys, draws)
    scheme = build_scheme(TCFG.dit, AdapterConfig(**acfg))
    to_port = lambda tree: train_params_from_numpy(scheme, jax.tree.map(np.asarray, tree),
                                                   device="cpu")
    injected = [_jax_draws(k, tuple(inp.train.shape)) for k in keys]
    section = bench.delta_a_step if method == "delta_a" else (
        lambda i, **kw: bench.lora_vs_denoise(i, dense_s=1.0, gen_steps=50, **kw))
    keys_out, out = section(inp, steps=1, draws=injected, train_params=to_port(tp0))
    np.testing.assert_allclose(out["losses"].numpy(), losses_j, rtol=LOSS_RTOL)
    want = to_port(tp_j)
    assert set(out["train_params"]) == set(want)
    for k in want:
        np.testing.assert_allclose(out["train_params"][k].numpy(), want[k].numpy(),
                                   **GRAD_TOL)
    moved = max(float((out["train_params"][k] - to_port(tp0)[k]).abs().max()) for k in want)
    assert moved > 1e-4  # the adapter trained
    assert all(v > 0 for v in keys_out.values())


def test_bsa_selection_drops_key_blocks():
    """At the test geometry keep 0.35 keeps 9 of 23 key blocks of 8 (the
    forced set: 8 conditioning blocks and the diagonal)."""
    tpf = GEO["lat_h"] // 2 * GEO["lat_w"] // 2
    cached, sk = bench.COND_LATENTS * tpf, (bench.COND_LATENTS + bench.GEN_LATENTS) * tpf
    cfg = BSAConfig(keep_ratio=bench.BSA_KEEP, block_q=GEO["block_q"], block_k=GEO["block_k"])
    assert (-(-sk // cfg.block_k), mlh.clamped_top_k(cfg, sk, cached)) == (23, 9)


@pytest.mark.parametrize("form", list(bench.FORMS))
def test_continuation_forms_match_jax_sample_latents(weights, draws, inp, form):
    """bench.py:77-164: each form's two runs against JAX's sample_latents
    with the same configs (W8A8 forms on JAX's quantize_dit_blocks_int8
    copy) and the same initial noise."""
    params, int8_params, _ = weights
    spec = bench.FORMS[form]
    keys, out = bench.continuations(inp, steps=GEN_STEPS, forms=(form,),
                                    init_noises=[torch.from_numpy(n) for n in draws["noises"]])
    kw = dict(num_gen_latents=bench.GEN_LATENTS, num_steps=GEN_STEPS, lat_h=GEO["lat_h"],
              lat_w=GEO["lat_w"], cond_latents=jnp.asarray(draws["cond"]), use_kv_cache=True)
    if spec.get("bsa"):
        kw["bsa_cfg"] = jconfig.BSAConfig(keep_ratio=0.35, block_q=GEO["block_q"],
                                          block_k=GEO["block_k"])
    if spec.get("pab"):
        kw["pab_cfg"] = jconfig.PABConfig(every=4, start_frac=0.06, end_frac=0.96)
    if spec.get("cfgr"):
        kw["cfgr_cfg"] = jconfig.CFGReuseConfig(every=2, start_frac=0.06, end_frac=0.96)
    model = int8_params if spec.get("int8") else params
    text = jnp.asarray(draws["text"])
    mask = jnp.ones((1, text.shape[1]), jnp.int32)
    tol = INT8_TOL if spec.get("int8") else TOL
    for got, noise in zip(out["latents"][form], draws["noises"]):
        want = jsampler.sample_latents(model, JCFG.dit, JCFG.scheduler, jax.random.PRNGKey(0),
                                       text, mask, jnp.zeros_like(text), mask, 4.0,
                                       init_noise=jnp.asarray(noise), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)
    assert list(keys) == [f"gen_{GEN_STEPS}step_{spec['key']}_s"] + (
        ["gen_frames_per_s"] if form == "dense" else [])


def test_video_parallel_matches_jax_make_batched_train_chunk(weights, draws, inp):
    """bench.py:195-226: two lanes from the same delta_a init, a warm-up
    chunk on the keys 300 + 50 v + s and the timed one on 400 + 50 v + s,
    2 steps each, against make_batched_train_chunk on the same draws."""
    params = weights[0]
    V, K = 2, 2
    scheme_j = jax_build_scheme(JCFG.dit, jconfig.AdapterConfig(method="delta_a"))
    tx = jax_build_optimizer(jconfig.OptimConfig(lr=5e-3))
    chunk = make_batched_train_chunk(scheme_j, JCFG.dit, tx)
    stack = lambda *xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)
    tp0 = scheme_j.init(jax.random.PRNGKey(5), base_params=params)
    tps, states = stack(*[tp0] * V), stack(*[tx.init(tp0)] * V)
    batch = [jnp.stack([x] * V) for x in _jax_window(draws)]
    losses_j, injected = [], []
    for base in (300, 400):
        rngs = jnp.stack([jnp.stack([jax.random.PRNGKey(base + v * 50 + s) for s in range(K)])
                          for v in range(V)])
        tps, states, loss, _ = chunk(tps, states, params, *batch, rngs)
        losses_j.append(np.asarray(loss))
        injected.append([[_jax_draws(rngs[v, s], tuple(inp.train.shape)) for v in range(V)]
                         for s in range(K)])
    scheme = build_scheme(TCFG.dit, AdapterConfig(method="delta_a"))
    lanes = [train_params_from_numpy(scheme, jax.tree.map(np.asarray, tp0), device="cpu")] * V
    stacked = {k: torch.stack([t[k] for t in lanes]) for k in lanes[0]}
    keys, out = bench.video_parallel(inp, tta_step_s=1.0, lanes=V, steps=K, draws=injected,
                                     train_params=stacked)
    np.testing.assert_allclose(out["losses"].numpy(), np.concatenate(losses_j, axis=1),
                               rtol=1e-4)
    for v in range(V):
        want = train_params_from_numpy(
            scheme, jax.tree.map(lambda a: np.asarray(a[v]), tps), device="cpu")
        for k in want:
            np.testing.assert_allclose(out["train_params"][k][v].numpy(), want[k].numpy(),
                                       **GRAD_TOL)
    assert list(keys) == ["vp2_step_s_per_video", "vp2_speedup_vs_sequential", "vp2_note"]


def _reference_accounting(**values):
    """The root bench.py's accounting statements (peak :233, nhw and
    s_train :234-235, matmul_params :237-243, train_mfu_of :245-251,
    gen_mfu_of :253-260, baseline_step_s :395, per_param_ratio :396, the
    reference's FLOPs and MFU :401-406), executed from its source with
    ``values`` bound."""
    main = next(n for n in ast.parse(open(REFERENCE).read()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = {"peak", "nhw", "s_train", "matmul_params", "train_mfu_of", "gen_mfu_of",
             "baseline_step_s", "per_param_ratio", "Dr", "p_block_ref", "ref_flops",
             "ref_mfu"}

    def defines(node):
        if isinstance(node, ast.FunctionDef):
            return {node.name}
        if isinstance(node, ast.Assign):
            return {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        return set()

    body = [n for n in main.body if defines(n) & names]
    ns = dict(values)
    exec(compile(ast.Module(body=body, type_ignores=[]), REFERENCE, "exec"), ns)
    return ns


@pytest.mark.parametrize("preset", ["longcat_bench", "longcat_bench_3b", "flagship"])
def test_accounting_equals_bench_py(preset):
    """matmul_params, the train and generation MFU, per_param_ratio and
    ref_mfu against bench.py's own expressions on the JAX config of the
    same model; the one difference is the peak, the card's."""
    port, ref = {"longcat_bench": (longcat_bench().dit, jconfig.longcat_bench().dit),
                 "longcat_bench_3b": (longcat_bench_3b().dit, jconfig.longcat_bench_3b().dit),
                 "flagship": (bench.flagship_config(), jconfig.DiTConfig())}[preset]
    step_s, gen_step_s, n = 0.33, 0.28, 1.19e9
    ns = _reference_accounting(lat_h=bench.LAT_H, lat_w=bench.LAT_W, tta_step_s=step_s,
                               n_params=n)
    assert ns["peak"] != bench.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"]
    ns["peak"] = peak = bench.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"]
    nhw, s_train = bench.token_counts(bench.LAT_H, bench.LAT_W)
    assert (nhw, s_train) == (ns["nhw"], ns["s_train"]) == (1560, 4680)
    assert bench.matmul_params(port) == ns["matmul_params"](ref)
    assert bench.train_flops(port, s_train) / step_s / peak == pytest.approx(
        ns["train_mfu_of"](ref, step_s), rel=1e-12)
    assert bench.gen_flops(port, nhw) / gen_step_s / peak == pytest.approx(
        ns["gen_mfu_of"](ref, gen_step_s), rel=1e-12)
    assert bench.per_param_ratio(step_s, n) == pytest.approx(ns["per_param_ratio"], rel=1e-12)
    assert bench.ref_mfu(s_train) == pytest.approx(ns["ref_mfu"], rel=1e-12)
    assert bench.ref_flops(s_train) == ns["ref_flops"]


@pytest.fixture
def tiny_main(monkeypatch):
    """``main --device cpu`` at the tiny size: the presets, counts and
    geometry replaced, the card's peak and nvidia-smi line stood in."""
    monkeypatch.setattr(bench, "longcat_bench", lambda: TINY)
    monkeypatch.setattr(bench, "longcat_bench_3b", lambda: TINY2)
    monkeypatch.setattr(bench, "flagship_config", lambda: TINY_FLAGSHIP)
    monkeypatch.setattr(bench, "COUNTS", TINY_COUNTS)
    monkeypatch.setattr(bench, "GEOMETRY", GEO)
    monkeypatch.setattr(bench, "peak_flops", lambda device: 989e12)
    monkeypatch.setattr(bench, "device_info", lambda: dict(CARD))
    return lambda: bench.main(["--device", "cpu"])


def test_output_line_has_the_reference_keys(tiny_main, capsys):
    """One JSON line with bench.py's structure and keys (read from its
    source) but for the device key and the dropped recorded 93-frame
    number, no null; at the script's counts the keys are bench.py's own."""
    rec = tiny_main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    top, detail = chip_smoke.reference_bench_keys(TINY_COUNTS)
    assert list(rec) == top and list(rec["detail"]) == detail
    assert all(v is not None for v in list(rec.values()) + list(rec["detail"].values()))
    assert rec["metric"] == "delta_a_tta_step_seconds_480p_1p2B_h100"
    assert rec["device"] == CARD
    _, full = chip_smoke.reference_bench_keys(SCRIPT_COUNTS)
    assert {"gen_50step_cfg_29frames_s", "scale2_gen_10step_s", "vp2_note"} <= set(full)
    assert "gen_93frame_50step_s_recorded" not in full


def test_source_has_no_tpu_constant_and_no_except():
    """No TPU peak or name, and no handler that could let a section's
    failure through."""
    path = bench.__file__
    src = open(path).read()
    assert "197e12" not in src and "v5e" not in src.lower()
    assert not [n for n in ast.walk(ast.parse(src)) if isinstance(n, (ast.Try, ast.ExceptHandler))]


@pytest.mark.parametrize("section", ["setup", "delta_a_step", "continuations",
                                     "lora_vs_denoise", "video_parallel", "scale2", "scale3"])
def test_a_failing_section_fails_main(tiny_main, monkeypatch, capsys, section):
    def boom(*a, **k):
        raise RuntimeError(f"{section} failed")

    monkeypatch.setattr(bench, section, boom)
    with pytest.raises(RuntimeError, match=f"{section} failed"):
        tiny_main()
    assert capsys.readouterr().out == ""


@pytest.fixture
def counted(monkeypatch):
    """The plain-path kernel calls counted in the wrappers' counters, as the
    card counts launches."""
    ref_fwd, ref_bwd = fa.attention_reference, fa.FlashAttentionFunction.backward
    ref_bsa, ref_sum = bsa.bsa_reference, bsa.block_sum_reference

    def fwd(*a, **k):
        fa.launches += 1
        return ref_fwd(*a, **k)

    def bwd(ctx, do):
        need = ctx.needs_input_grad
        fa.bwd_dq_launches += int(need[0])
        fa.bwd_dkv_launches += int(need[1] or need[2])
        return ref_bwd(ctx, do)

    def sparse(*a, **k):
        if k.get("qk_int8"):
            bsa.bsa_int8_launches += 1
        else:
            bsa.bsa_launches += 1
        return ref_bsa(*a, **k)

    def block_sum(*a, **k):
        bsa.bsa_block_sum_launches += 1
        return ref_sum(*a, **k)

    monkeypatch.setattr(fa, "attention_reference", fwd)
    monkeypatch.setattr(fa.FlashAttentionFunction, "backward", staticmethod(bwd))
    monkeypatch.setattr(bsa, "bsa_reference", sparse)
    monkeypatch.setattr(bsa, "block_sum_reference", block_sum)


def test_bench_phase_launches_count_the_plain_path(counted, monkeypatch):
    """chip_smoke's [bench] on the CPU at tiny size (its counts, the tiny
    presets): the plain-path calls equal ``bench_launches`` (the phase's
    gate), every kernel of the path but int8-QK is reached, and the
    phase's other gates hold."""
    monkeypatch.setattr(bench, "peak_flops", lambda device: chip_smoke.H100_BF16_FLOPS)
    monkeypatch.setattr(bench, "device_info", lambda: dict(CARD))
    got = chip_smoke.phase_bench_runs(fa, bsa, TINY, cfg2=TINY2, flagship=TINY_FLAGSHIP,
                                      geometry=GEO, card="cpu")
    assert got == chip_smoke.bench_launches(chip_smoke.BENCH["counts"], TINY.dit, TINY2.dit,
                                            TINY_FLAGSHIP)
    assert got.pop("bsa_fwd_qk_int8") == 0 and min(got.values()) > 0


def test_device_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main([])


def test_peak_is_the_cards_and_an_unknown_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert bench.peak_flops(torch.device("cuda")) == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="A100-SXM4-80GB"):
        bench.peak_flops(torch.device("cuda"))
    with pytest.raises(RuntimeError, match="'cpu'"):
        bench.peak_flops("cpu")


def test_device_info_reads_nvidia_smi(monkeypatch):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: Done())
    assert bench.device_info() == {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
