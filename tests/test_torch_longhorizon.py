"""The port's ``scripts/measure_longhorizon`` against the JAX package on
longcat_tiny (the same DiT weights through models/weights.py, the same
injected initial noise, text and conditioning; fp32 on the CPU, where the
port runs its plain versions and JAX its Pallas kernels in interpret
mode), with the JAX sampler calls the reference script's ``main`` makes.

Weights: init_dit's draw with its matrices scaled by 2.5 (the ``weights``
fixture). Geometry: latents 6 x 10 (15 tokens a latent frame), 2
conditioning and 7 generated latents, BSA blocks of 8: 105 queries and 135 keys, both
ragged in blocks, the query offset (30) inside a block; 17 key blocks,
of which keep 0.35 takes 6 and keep 0.15 the forced set's 5, as at the
93-frame geometry keep 0.15 takes the clamp's 8 of 43.

Tolerances (those of test_torch_decode_levers.py):
- the dense decode and the 16-bit lever stack: 1e-4 abs / 1e-4 rel
  (summation order only; block selection is exact);
- with W8A8 or int8 QK^T: 2e-3 abs (a value on a rounding boundary can
  land one int8 step apart);
- latent corr and relative error: within 1e-3 of the values computed
  from JAX's latents.
"""

import argparse
import ast
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu import config as jconfig
from longcat_video_tta_tpu.models import dit as jdit
from longcat_video_tta_tpu.ops import bsa as jbsa
from longcat_video_tta_tpu.ops.quant import quantize_dit_blocks_int8 as jax_quantize
from longcat_video_tta_tpu.pipeline import sampler as jsampler
from longcat_video_tta_tpu_torch.config import BSAConfig, longcat_bench, longcat_tiny
from longcat_video_tta_tpu_torch.models.weights import load_dit_from_numpy
from longcat_video_tta_tpu_torch.ops import bsa
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.scripts import measure_longhorizon as mlh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "scripts", "measure_longhorizon.py")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
import measure_longhorizon as jax_mlh  # noqa: E402  (the reference script)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=0)
STAT_TOL = 1e-3
JCFG = jconfig.longcat_tiny()
TCFG = longcat_tiny()
GEO = dict(lat_h=6, lat_w=10, cond_latents=2, block_q=8, block_k=8)
GEN_LATENTS = 7
WEIGHT_SCALE = 2.5
LEVERS = ["--pab-every", "2", "--pab-start", "0.06", "--pab-end", "0.96",
          "--cfg-reuse-every", "2", "--cfg-reuse-start", "0.06", "--cfg-reuse-end", "0.96"]

CASES = {
    # mode, flags (each run: 5 steps, 7 generated latents, on the CPU)
    "corr_segmented_int8_pab_cfg_reuse": ("corr", ["--keep", "0.15", "--segment", "2",
                                                   *LEVERS]),
    "corr_one_pass_no_int8": ("corr", ["--keep", "0.35", "--segment", "0", "--no-int8"]),
    "corr_segmented_int8qk_pab_cfg_reuse": ("corr", ["--keep", "0.35", "--segment", "2",
                                                     "--int8qk", *LEVERS]),
    "wall_segmented_int8qk_pab_cfg_reuse": ("wall", ["--keep", "0.15", "--segment", "2",
                                                     "--int8qk", *LEVERS]),
    "wall_one_pass_no_int8": ("wall", ["--keep", "0.35", "--segment", "0", "--no-int8"]),
}


def _args(mode, flags):
    return mlh.parse_args(["--mode", mode, "--steps", "5", "--gen-latents",
                           str(GEN_LATENTS), "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def weights():
    """init_dit's draw with every matrix (a leaf of two or more dimensions)
    scaled by WEIGHT_SCALE, the same tree in both packages. At init_dit's
    0.02 the levers move these tiny latents by less than 1e-5, under every
    tolerance above; scaled by 2.5, BSA alone moves them by up to 3e-3 and
    with W8A8 by up to 1e-2, while the two packages stay within 7e-4 of
    each other with int8 and 2e-6 without (by 4, int8 QK^T's rounding
    flips grow past 2e-3 over the 5 steps)."""
    params = jdit.init_dit(jax.random.PRNGKey(0), JCFG.dit, zero_init=False)
    params = jax.tree.map(lambda a: a * WEIGHT_SCALE if a.ndim >= 2 else a, params)
    return params, load_dit_from_numpy(jax.tree.map(np.asarray, params), TCFG.dit, "cpu")


@pytest.fixture(scope="module")
def draws():
    """text [1, 16, 48], cond [1, 16, 2, 6, 10], two initial noises."""
    rng = np.random.default_rng(0)
    text = rng.standard_normal((1, TCFG.dit.text_len, TCFG.dit.text_dim)).astype(np.float32)
    cond = rng.standard_normal((1, 16, GEO["cond_latents"], GEO["lat_h"], GEO["lat_w"]))
    noises = [rng.standard_normal((1, 16, GEN_LATENTS, GEO["lat_h"], GEO["lat_w"]))
              for _ in range(2)]
    return text, cond.astype(np.float32), [n.astype(np.float32) for n in noises]


def _jax_run(params, args, draws, i, levers, segmented):
    """One of the reference main's sampler calls."""
    text, cond, noises = draws
    mask = jnp.ones((1, text.shape[1]), jnp.int32)
    kw = dict(num_gen_latents=args.gen_latents, num_steps=args.steps, lat_h=GEO["lat_h"],
              lat_w=GEO["lat_w"], cond_latents=jnp.asarray(cond), use_kv_cache=True,
              init_noise=jnp.asarray(noises[i]))
    if levers:
        kw["bsa_cfg"] = jconfig.BSAConfig(keep_ratio=args.keep, qk_int8=args.int8qk,
                                          block_q=GEO["block_q"], block_k=GEO["block_k"])
        if args.pab_every > 0:
            kw["pab_cfg"] = jconfig.PABConfig(every=args.pab_every,
                                              start_frac=args.pab_start,
                                              end_frac=args.pab_end)
        if args.cfg_reuse_every > 0:
            kw["cfgr_cfg"] = jconfig.CFGReuseConfig(every=args.cfg_reuse_every,
                                                    start_frac=args.cfg_reuse_start,
                                                    end_frac=args.cfg_reuse_end)
    if segmented:
        sampler, kw["segment_steps"] = jsampler.sample_latents_segmented, args.segment
    else:
        sampler = jsampler.sample_latents
    t = jnp.asarray(text)
    out = sampler(params, JCFG.dit, JCFG.scheduler, jax.random.PRNGKey(7), t, mask,
                  jnp.zeros_like(t), mask, 4.0, **kw)
    return np.asarray(out, np.float32)


def _port_run(dit, args, draws):
    text, cond, noises = draws
    return mlh.measure_longhorizon(args, TCFG, dit=dit, text=torch.from_numpy(text),
                                   cond=torch.from_numpy(cond),
                                   init_noises=[torch.from_numpy(n) for n in noises],
                                   device="cpu", **GEO)


def _reference_dict_keys():
    """The keys of the reference script's two JSON lines, read from its
    source: {mode: [keys]}."""
    out = {}
    for node in ast.walk(ast.parse(open(REFERENCE).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys = [k.value for k in d.keys]
            out[d.values[keys.index("mode")].value] = keys
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_measure_longhorizon_matches_jax(weights, draws, case):
    params, dit = weights
    mode, flags = CASES[case]
    args = _args(mode, flags)
    record, latents = _port_run(dit, args, draws)
    assert list(record) == _reference_dict_keys()[mode]
    int8 = not args.no_int8
    qparams = jax.jit(jax_quantize)(params) if int8 else params
    lever_tol = INT8_TOL if (int8 or args.int8qk) else TOL
    if mode == "corr":
        segmented = args.segment > 0
        ref = _jax_run(params, args, draws, 0, levers=False, segmented=segmented)
        fast = _jax_run(qparams, args, draws, 0, levers=True, segmented=segmented)
        np.testing.assert_allclose(latents[0].numpy(), ref, **TOL)
        np.testing.assert_allclose(latents[1].numpy(), fast, **lever_tol)
        r, f = ref.astype(np.float64).ravel(), fast.astype(np.float64).ravel()
        corr = np.corrcoef(r, f)[0, 1]
        rel = np.linalg.norm(f - r) / np.linalg.norm(r)
        assert abs(record["latent_corr"] - corr) <= STAT_TOL
        assert abs(record["rel_err"] - rel) <= STAT_TOL
        # the levers moved the latents by more than the comparison's tolerance
        assert np.abs(fast - ref).max() > 4 * lever_tol["atol"]
        assert (record["int8"], record["keep"], record["segment"]) == (
            int8, args.keep, args.segment)
    else:
        for i in range(2):
            want = _jax_run(qparams, args, draws, i, levers=True, segmented=True)
            np.testing.assert_allclose(latents[i].numpy(), want, **lever_tol)
        assert record["frames"] == 1 + (GEN_LATENTS - 1) * 4
        assert record["int8qk"] == args.int8qk and record["s_per_step"] >= 0


def test_flags_and_defaults_match_the_reference():
    """The reference's flags, choices and defaults, plus --device cuda."""
    class Stop(Exception):
        pass

    captured = {}

    def grab(self, *a, **k):
        captured["parser"] = self
        raise Stop

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Stop):
            jax_mlh.main()

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    ours, ref = table(mlh.build_parser()), table(captured["parser"])
    assert ours.pop("device") == (("--device",), "cuda", None, "_StoreAction")
    assert ours == ref


def test_clamped_top_k_at_the_93_frame_geometry():
    """43 key blocks of 1024 (6240 cached + 37 440 fresh keys): keep 0.35
    takes 16, keep 0.15 the forced set's 8 (7 conditioning blocks and the
    diagonal), equal to the rule of JAX's DiT and bsa_attention."""
    tpf, ncond, sq, sk = chip_smoke.longhorizon_geometry(longcat_bench().dit)
    assert (tpf, ncond, sq, sk) == (1560, 6240, 37440, 43680)

    class Captured(Exception):
        pass

    def capture(*a, top_k, **k):
        raise Captured(top_k)

    for keep, want in ((0.35, 16), (0.15, 8)):
        cfg = BSAConfig(keep_ratio=keep)
        assert mlh.clamped_top_k(cfg, sk, ncond) == want
        # JAX: the DiT's keep-ratio rule (models/dit.py), then bsa_attention's
        # clamp, read where it hands top_k to select_blocks
        jcfg = jconfig.BSAConfig(keep_ratio=keep)
        n_kb = -(-sk // jcfg.block_k)
        top_k = min(n_kb, max(jcfg.min_blocks, -int(-n_kb * jcfg.keep_ratio // 1)))
        q = jnp.zeros((1, sq, 1, 8), jnp.bfloat16)
        k = jnp.zeros((1, sk, 1, 8), jnp.bfloat16)
        with mock.patch.object(jbsa, "select_blocks", capture):
            with pytest.raises(Captured) as got:
                jbsa.bsa_attention(q, k, k, top_k=top_k, block_q=jcfg.block_q,
                                   block_k=jcfg.block_k, num_cond_tokens=ncond)
        assert got.value.args[0] == want


@pytest.fixture
def counted(monkeypatch):
    """The plain-path kernel calls, counted as the card counts launches."""
    calls = {"flash_fwd": 0, "bsa_fwd": 0, "bsa_fwd_qk_int8": 0, "bsa_block_sum": 0}
    ref_fwd, ref_bsa, ref_sum = fa.attention_reference, bsa.bsa_reference, \
        bsa.block_sum_reference

    def fwd(*a, **k):
        calls["flash_fwd"] += 1
        return ref_fwd(*a, **k)

    def sparse(*a, **k):
        calls["bsa_fwd_qk_int8" if k.get("qk_int8") else "bsa_fwd"] += 1
        return ref_bsa(*a, **k)

    def block_sum(*a, **k):
        calls["bsa_block_sum"] += 1
        return ref_sum(*a, **k)

    monkeypatch.setattr(fa, "attention_reference", fwd)
    monkeypatch.setattr(bsa, "bsa_reference", sparse)
    monkeypatch.setattr(bsa, "block_sum_reference", block_sum)
    return calls


@pytest.mark.parametrize("mode,extra", [("corr", ()), ("wall", ()),
                                        ("corr", ("--pab-every", "3", "--segment", "0"))],
                         ids=["corr", "wall_int8qk_pab_cfg_reuse", "corr_pab3_one_pass"])
def test_longhorizon_launches_count_the_plain_path(weights, draws, counted, mode, extra):
    """chip_smoke [longhorizon]'s flags (10 steps in segments of 5; wall:
    int8 QK^T, PAB every 4, CFG reuse every 2) at tiny size: the plain-path
    calls equal ``longhorizon_launches``."""
    args = mlh.parse_args(chip_smoke.longhorizon_argv(mode, "--device", "cpu",
                                                      "--gen-latents", str(GEN_LATENTS),
                                                      *extra))
    assert args.steps == chip_smoke.LONGHORIZON["steps"]
    _port_run(weights[1], args, draws)
    assert counted == chip_smoke.longhorizon_launches(args, TCFG.dit.depth)
    assert counted["bsa_fwd_qk_int8" if args.int8qk else "bsa_fwd"] > 0
