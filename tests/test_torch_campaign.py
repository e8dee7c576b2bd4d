"""The port's science-loop tools (longcat_video_tta_tpu_torch/scripts/ and
models/convert.py::save_checkpoint_dir) against the reference's scripts
and converters on the CPU: the upstream-layout writer (bit for bit), the
synthetic towers through the port's loaders, the campaign drivers' argv
and timing table, the probe, the prompt list, and chip_smoke's [demo]
launch derivation against the counted plain-path attention calls.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from longcat_video_tta_tpu.config import longcat_tiny as jax_tiny
from longcat_video_tta_tpu.models import convert as jconvert
from longcat_video_tta_tpu_torch.config import longcat_demo, longcat_tiny
from longcat_video_tta_tpu_torch.models import convert
from longcat_video_tta_tpu_torch.models.weights import (
    load_dit_from_numpy,
    load_umt5_from_numpy,
    load_vae_from_numpy,
)
from longcat_video_tta_tpu_torch.ops import flash_attention as fa
from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle
from longcat_video_tta_tpu_torch.scripts import (
    make_synth_towers,
    prepare_t2v_prompts,
    pretrain_demo,
    probe_tta_grid,
    run_campaign,
    run_demo_campaign,
)
from longcat_video_tta_tpu_torch.utils.safetensors import ShardIndex, save_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
import run_campaign as jax_run_campaign  # noqa: E402  (the reference scripts)
import run_demo_campaign as jax_run_demo_campaign  # noqa: E402
from synth_checkpoints import make_dit_sd, make_umt5_sd, make_vae_sd  # noqa: E402

torch.set_num_threads(1)

COMPONENTS = (("dit", make_dit_sd, "dit"), ("vae", make_vae_sd, "vae"),
              ("text_encoder", make_umt5_sd, "text"))


def _write_synth(folder, cfg):
    sds = {}
    for comp, make, sub in COMPONENTS:
        sds[comp] = make(getattr(cfg, sub))
        os.makedirs(os.path.join(folder, comp))
        save_file({k: torch.from_numpy(v) for k, v in sds[comp].items()},
                  os.path.join(folder, comp, "model.safetensors"))
    return sds


def _read(folder, comp):
    sd = ShardIndex(os.path.join(folder, comp))
    return {k: sd[k] for k in sd.keys()}


@pytest.mark.parametrize("cfg", [longcat_tiny(), longcat_demo()], ids=["tiny", "demo"])
def test_checkpoint_writer_round_trips_the_upstream_layout(tmp_path, cfg):
    """tests/synth_checkpoints.py's DiT (Linear patch embedding), VAE
    (bias-free norms, fused 1x1 to_qkv) and UMT5 (a relative-attention
    table per layer), loaded and written again: the same keys, shapes and
    bits (the DiT in its module's dtype: bf16 at longcat_demo), and the
    same again after a second load and write."""
    sds = _write_synth(tmp_path / "a", cfg)
    bundle = ModelBundle.from_checkpoint_dir(cfg, str(tmp_path / "a"), device="cpu")
    convert.save_checkpoint_dir(bundle, str(tmp_path / "b"), patch_conv=False)
    again = ModelBundle.from_checkpoint_dir(cfg, str(tmp_path / "b"), device="cpu")
    convert.save_checkpoint_dir(again, str(tmp_path / "c"), patch_conv=False)
    for comp, _, _ in COMPONENTS:
        b, c = _read(tmp_path / "b", comp), _read(tmp_path / "c", comp)
        assert set(b) == set(sds[comp]) == set(c)
        for k, ref in sds[comp].items():
            assert tuple(b[k].shape) == ref.shape == tuple(c[k].shape), k
            assert torch.equal(b[k], torch.from_numpy(ref).to(b[k].dtype)), k
            assert b[k].dtype == c[k].dtype and torch.equal(b[k], c[k]), k
    dit = _read(tmp_path / "b", "dit")
    assert {t.dtype for k, t in dit.items() if not k.startswith("t_embedder")} == {
        torch.float32 if cfg.dit.param_dtype == "float32" else torch.bfloat16}
    with open(tmp_path / "b" / "vae" / "config.json") as f:
        meta = json.load(f)
    assert meta["latents_mean"] == list(cfg.vae.latents_mean)
    assert meta["latents_std"] == list(cfg.vae.latents_std)


def test_written_checkpoint_through_the_reference_converters(tmp_path):
    """The default layout (the patch embedding as the upstream Conv3d), a
    trained VAE norm bias written beside its gamma, and new latent
    statistics: the reference's torch-layout converters read the written
    folders into the parameters the port's modules hold, and the port's
    loader reads them back equal."""
    cfg = longcat_tiny()
    bundle = ModelBundle.init_random(cfg, seed=5, device="cpu")
    with torch.no_grad():
        bundle.vae.dec.norm_out.bias.add_(0.25)
    bundle = pretrain_demo.with_latent_stats(bundle, np.linspace(-1, 1, 16),
                                             np.linspace(0.5, 2, 16))
    convert.save_checkpoint_dir(bundle, str(tmp_path))
    dit_sd = {k: v.numpy() for k, v in _read(tmp_path, "dit").items()}
    assert dit_sd["x_embedder.proj.weight"].shape == (cfg.dit.hidden_size, cfg.dit.in_channels,
                                                      *cfg.dit.patch_size)
    vae_sd = {k: v.numpy() for k, v in _read(tmp_path, "vae").items()}
    assert [k for k in vae_sd if k.endswith(".bias") and ".gamma" not in k
            and k.replace(".bias", ".gamma") in vae_sd] == ["decoder.head.0.bias"]
    umt5_sd = {k: v.numpy() for k, v in _read(tmp_path, "text_encoder").items()}
    jcfg = jax_tiny()
    tonp = lambda t: jax.tree.map(np.asarray, t)
    for ours, ref in (
            (bundle.dit, load_dit_from_numpy(
                tonp(jconvert.convert_torch_dit_state(dit_sd, jcfg.dit)), cfg.dit, "cpu")),
            (bundle.vae, load_vae_from_numpy(
                tonp(jconvert.convert_torch_vae_state(vae_sd, jcfg.vae)), cfg.vae, "cpu")),
            (bundle.text, load_umt5_from_numpy(
                tonp(jconvert.convert_torch_umt5_state(umt5_sd, jcfg.text)), cfg.text,
                "cpu"))):
        a, b = dict(ours.named_parameters()), dict(ref.named_parameters())
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    back = ModelBundle.from_checkpoint_dir(cfg, str(tmp_path), device="cpu")
    assert back.cfg.vae.latents_mean == bundle.cfg.vae.latents_mean
    assert torch.equal(back.vae.dec.norm_out.bias, bundle.vae.dec.norm_out.bias)


def test_writer_refuses_other_layouts(tmp_path):
    from longcat_video_tta_tpu_torch.models.backbones import cogvideox_tiny

    bundle = ModelBundle.init_random(cogvideox_tiny(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="LongCat layout"):
        convert.save_checkpoint_dir(bundle, str(tmp_path))


def test_synth_towers_load_through_the_port_loaders(tmp_path):
    """The seven towers under the reference script's file names and
    geometries, each read by the loader the runner uses."""
    from longcat_video_tta_tpu_torch.eval.i3d import load_i3d_params
    from longcat_video_tta_tpu_torch.eval.inception import load_inception_params
    from longcat_video_tta_tpu_torch.eval.lpips import load_lpips_params
    from longcat_video_tta_tpu_torch.eval.vbench_native import load_native_towers
    from longcat_video_tta_tpu_torch.tta.clip_gate import make_clip_scorer

    out = str(tmp_path)
    paths = make_synth_towers.main(["--out-dir", out, "--device", "cpu"])
    assert set(paths) == {"lpips", "i3d", "inception", "clip", "dino", "aesthetic", "musiq"}
    assert sorted(os.listdir(out)) == sorted([
        "SYNTHETIC_WEIGHTS", "aesthetic_l14.pth", "clip", "clip_l14", "dino_config.json",
        "dino_vits16.pth", "i3d.pth", "inception_v3.pth", "lpips_alex.pth",
        "musiq_config.json", "musiq_spaq.pth"])
    load_lpips_params(paths["lpips"], "cpu")
    load_i3d_params(paths["i3d"], "cpu")
    load_inception_params(paths["inception"], "cpu")
    scorer = make_clip_scorer(paths["clip"], device="cpu", allow_hash_tokenizer=True)
    score = scorer(np.random.default_rng(0).uniform(0, 1, (4, 32, 48, 3)).astype(np.float32),
                   "a ball moving across the scene")
    assert np.isfinite(np.asarray(score, np.float64)).all()
    towers = load_native_towers(out, "cpu")
    assert set(towers) == {"dino", "musiq", "aesthetic"}
    assert towers["dino"][1].width == 64 and towers["dino"][1].num_layers == 2
    with open(os.path.join(out, "clip", "config.json")) as f:
        hf = json.load(f)
    assert (hf["projection_dim"], hf["text_config"]["hidden_size"],
            hf["vision_config"]["num_hidden_layers"]) == (64, 128, 2)


def test_lpips_is_nan_on_frames_too_small_for_alexnet():
    """Frames whose maps the 3x3 / 2 pooling empties score NaN, as the
    reference's VALID pooling gives, instead of raising."""
    from longcat_video_tta_tpu.eval.lpips import lpips_alex as jax_lpips
    from longcat_video_tta_tpu_torch.eval.lpips import LPIPSAlex, lpips_alex

    model = LPIPSAlex()
    gen = torch.Generator().manual_seed(0)
    params = {}
    for name, p in model.named_parameters():
        with torch.no_grad():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen).abs() + 0.1)
        params[name] = p.detach().numpy()
    a, b = (np.random.default_rng(i).uniform(0, 1, (2, 16, 32, 3)).astype(np.float32)
            for i in range(2))
    assert np.isnan(lpips_alex(model, a, b).numpy()).all()
    jparams = {"shift": params["shift"], "scale": params["scale"],
               "convs": [{"kernel": np.transpose(params[f"convs.{i}.weight"], (2, 3, 1, 0)),
                          "bias": params[f"convs.{i}.bias"]} for i in range(5)],
               "lins": [params[f"lins.{i}"] for i in range(5)]}
    assert np.isnan(np.asarray(jax_lpips(jparams, a, b))).all()


def _results_tree(base):
    """A fixed campaign tree: a finished row (one failed video, one with a
    dense verify), an in-flight row and a row with no success."""
    series = os.path.join(base, "campaign_demo")
    rows = {
        "FULL": ("summary.json", [
            dict(success=True, train_time=3.25, gen_time=1.5, total_time=6.0, psnr=8.5,
                 fast_decode_verify={"dense_gen_time": 2.25}),
            dict(success=True, train_time=4.75, gen_time=1.25, total_time=7.5, psnr=9.25),
            dict(success=False, error="boom")]),
        "LORA_R4": ("checkpoint.json", [
            dict(success=True, train_time=2.0, gen_time=1.0, total_time=4.0, psnr=float("nan"))]),
        "NOTTA": ("summary.json", [dict(success=False)]),
    }
    for name, (file, results) in rows.items():
        os.makedirs(os.path.join(series, name))
        with open(os.path.join(series, name, file), "w") as f:
            json.dump({"results": results}, f)
    os.makedirs(os.path.join(series, "EMPTY"))


def test_timing_table_matches_the_reference(tmp_path):
    _results_tree(tmp_path)
    ours = run_campaign.timing_table(str(tmp_path), series="campaign_demo")
    assert ours == jax_run_campaign.timing_table(str(tmp_path), series="campaign_demo")
    assert "| LORA_R4 (partial) | 1 |" in ours and "| NOTTA | 0 | - |" in ours


def _dry_run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    out = buf.getvalue()
    return json.loads(out[out.index("\n[\n") + 1:])


@pytest.fixture
def dry_folders(tmp_path):
    """A towers folder and a checkpoint folder both drivers take as
    present (so a dry run neither draws towers nor pretrains)."""
    towers, ckpt = tmp_path / "towers", tmp_path / "ckpt"
    towers.mkdir()
    (towers / "lpips_alex.pth").touch()
    for comp in ("dit", "vae", "text_encoder"):
        (ckpt / comp).mkdir(parents=True)
    (ckpt / "model_config.json").write_text("{}")
    (ckpt / "vae" / "config.json").write_text("{}")
    return ["--dry-run", "--max-videos", "2", "--output-base", str(tmp_path / "out"),
            "--ckpt-dir", str(ckpt), "--towers-dir", str(towers)]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_demo_campaign_dry_run_matches_the_reference(dry_folders, smoke):
    """Every row of every campaign_demo YAML, in the reference driver's
    order, with the reference's runner argv. The documented differences of
    the port: each row runs on --device (appended), and the YAMLs'
    compile_cache_dir (XLA's cache in the reference) names the kernels'
    build folder, --compile-cache-dir (default "auto")."""
    argv = dry_folders + (["--smoke"] if smoke else [])
    ref = _dry_run(jax_run_demo_campaign.main, argv)
    ours = _dry_run(run_demo_campaign.main, argv + ["--device", "cpu"])
    assert [r["run_id"] for r in ours] == [r["run_id"] for r in ref]
    assert len(ref) == 10  # the nine YAMLs, full with its ES-off row
    for r, o in zip(ref, ours):
        assert o["argv"][-2:] == ["--device", "cpu"]
        want = list(r["argv"])
        if "--compile-cache-dir" in want:
            assert not smoke
            want[want.index("--compile-cache-dir") + 1] = "auto"
        assert o["argv"][:-2] == want, r["run_id"]


def test_bench_campaign_dry_run_matches_the_reference(tmp_path):
    argv = ["--smoke", "--dry-run", "--max-videos", "2", "--output-base", str(tmp_path)]
    ref = _dry_run(jax_run_campaign.main, argv)
    ours = _dry_run(run_campaign.main, argv + ["--device", "cpu"])
    assert [r["run_id"] for r in ours] == [r["run_id"] for r in ref] and ref
    for r, o in zip(ref, ours):
        assert o["argv"] == r["argv"] + ["--device", "cpu"], r["run_id"]


def test_entry_points_default_to_the_card(tmp_path):
    """Without a GPU the drivers raise before they write anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for main, argv in (
            (run_demo_campaign.main, ["--output-base", str(tmp_path / "d")]),
            (run_campaign.main, ["--output-base", str(tmp_path / "c")]),
            (make_synth_towers.main, ["--out-dir", str(tmp_path / "t")]),
            (probe_tta_grid.main, ["--out", str(tmp_path / "p")])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(argv)
    assert not any(os.scandir(tmp_path))


TINY_RUN = ["--preset", "longcat_tiny", "--synthetic", "2", "--device", "cpu",
            "--height", "16", "--width", "32", "--num-cond-frames", "5", "--num-frames", "5",
            "--gen-start-frame", "16", "--tta-total-frames", "13",
            "--num-inference-steps", "3", "--caption-guard-mode", "off"]


def test_probe_pairs_each_video_with_notta(tmp_path, monkeypatch):
    """The probe's loop on the tiny model: a NOTTA run, then one grid row
    paired with it by video name."""
    from longcat_video_tta_tpu_torch.runners.run_tta import main as run_main

    notta = str(tmp_path / "notta")
    run_main(TINY_RUN + ["--method", "none", "--output-dir", notta])
    base = TINY_RUN[:3] + ["--data-dir", os.path.join(notta, "synthetic_data")] + TINY_RUN[4:]
    base.remove("--synthetic")
    monkeypatch.setattr(probe_tta_grid, "BASE", base)
    monkeypatch.setattr(probe_tta_grid, "GRID", [("full_s2", "full", 1e-3, 2)])
    assert probe_tta_grid.main(["--n", "2", "--out", str(tmp_path / "probe"), "--device", "cpu",
                                "--baseline", os.path.join(notta, "summary.json")]) == 0
    with open(tmp_path / "probe" / "grid_report.json") as f:
        (row,) = json.load(f)
    with open(os.path.join(notta, "summary.json")) as f:
        ref = {r["video"]: r["psnr"] for r in json.load(f)["results"]}
    with open(tmp_path / "probe" / "full_s2" / "summary.json") as f:
        got = {r["video"]: r["psnr"] for r in json.load(f)["results"]}
    diffs = [got[v] - ref[v] for v in got]
    assert row["n"] == 2 and row["wins"] == sum(d > 0 for d in diffs)
    assert row["mean_dpsnr"] == round(sum(diffs) / 2, 4)


def test_prompt_list_matches_the_reference(tmp_path, monkeypatch):
    import prepare_t2v_prompts as jax_prompts

    from longcat_video_tta_tpu_torch.runners.run_tta import make_synthetic_dataset

    data = make_synthetic_dataset(str(tmp_path / "data"), 5, 8, 8, frames=2)
    ours = prepare_t2v_prompts.main(["--data-dir", data, "--output", str(tmp_path / "a.json"),
                                     "--max-prompts", "3"])
    monkeypatch.setattr(sys, "argv", ["x", "--data-dir", data, "--output",
                                      str(tmp_path / "b.json"), "--max-prompts", "3"])
    jax_prompts.main()
    with open(tmp_path / "b.json") as f:
        assert json.load(f) == ours and len(ours) == 3


# ---------------------------------------------------------------------------
# chip_smoke [demo]'s launch derivation
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """The plain-path attention calls, counted as the card counts launches."""
    calls = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    ref_fwd, ref_bwd = fa.attention_reference, fa.FlashAttentionFunction.backward

    def fwd(*a, **k):
        calls["flash_fwd"] += 1
        return ref_fwd(*a, **k)

    def bwd(ctx, do):
        need = ctx.needs_input_grad
        calls["flash_bwd_dq"] += int(need[0])
        calls["flash_bwd_dkv"] += int(need[1] or need[2])
        return ref_bwd(ctx, do)

    monkeypatch.setattr(fa, "attention_reference", fwd)
    monkeypatch.setattr(fa.FlashAttentionFunction, "backward", staticmethod(bwd))
    return calls


def test_pretrain_launches_count_the_plain_path(tmp_path, counted):
    pretrain_demo.main(["--smoke", "--out-dir", str(tmp_path), "--device", "cpu",
                        "--dit-steps", "3"])
    assert not longcat_tiny().dit.remat  # as longcat_demo
    assert counted == chip_smoke.pretrain_launches(longcat_tiny().dit.depth, 3)


@pytest.mark.parametrize("method,flags", [
    ("none", []),
    ("full", ["--steps", "6", "--es-check-every", "2", "--es-patience", "1", "--lr", "1e-2"]),
    ("full", ["--steps", "3", "--es-disable"]),
], ids=["notta", "full_es", "full_es_off"])
def test_demo_row_launches_count_the_plain_path(tmp_path, counted, method, flags):
    """A row's launches from its summary (steps run, the early stopper's
    checks) equal the plain-path calls of the runner's run."""
    from longcat_video_tta_tpu_torch.runners.run_tta import main as run_main

    out = str(tmp_path / "run")
    run_main(TINY_RUN + ["--method", method, "--output-dir", out] + flags)
    with open(os.path.join(out, "summary.json")) as f:
        results = json.load(f)["results"]
    assert all(r["success"] for r in results)
    want = chip_smoke.demo_row_launches(method, results, longcat_tiny().dit.depth, 3)
    assert counted == want
    if method == "full" and "--es-disable" not in flags:
        assert any(len(r["losses"]) < 6 for r in results)  # the stopper cut a video short


def test_demo_phase_runs_longcat_demo_at_192x320():
    cfg = dataclasses.asdict(longcat_demo())
    assert (cfg["dit"]["hidden_size"], cfg["dit"]["depth"], cfg["dit"]["num_heads"],
            cfg["dit"]["ffn_dim"], cfg["vae"]["base_dim"]) == (768, 8, 6, 2048, 32)
    assert (chip_smoke.DEMO["height"], chip_smoke.DEMO["width"]) == (192, 320)
