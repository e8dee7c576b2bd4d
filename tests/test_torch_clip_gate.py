"""The port's CLIP gate against the JAX package: the CLIP and X-CLIP
towers (models/clip_text.py, models/clip.py, models/xclip.py), their
converters (models/convert.py), the frame preprocessing, the gate itself
(tta/clip_gate.py) and its feature-budget check (tta/split.py).

Tiny random ``transformers`` models build the state dicts, as
tests/test_clip_vision.py and tests/test_xclip.py do; the JAX converters
and the port's read the same dict. chip_smoke.py's synthetic checkpoint
layouts are held to those models' state dicts.

Tolerances (relative = max |port - jax| / max |jax|): image and text
embeddings and the CLIP scorer's scores 1e-5 relative; X-CLIP scores (one
cosine per video, often near 0) 1e-5 absolute; the preprocessing 1e-5
absolute at 480 x 832 -> 224; the gate's decisions and records exactly.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu.config import ClipGateConfig as JGateConfig
from longcat_video_tta_tpu.config import CLIPTextConfig as JTextConfig
from longcat_video_tta_tpu.config import CLIPVisionConfig as JVisionConfig
from longcat_video_tta_tpu.config import EarlyStoppingConfig as JESConfig
from longcat_video_tta_tpu.config import FrameConfig as JFrameConfig
from longcat_video_tta_tpu.config import XCLIPConfig as JXConfig
from longcat_video_tta_tpu.models import clip as jclip
from longcat_video_tta_tpu.models import convert as jconvert
from longcat_video_tta_tpu.models import xclip as jxclip
from longcat_video_tta_tpu.tta import clip_gate as jgate
from longcat_video_tta_tpu.tta import split as jsplit
from longcat_video_tta_tpu_torch.config import (
    ClipGateConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    EarlyStoppingConfig,
    FrameConfig,
    XCLIPConfig,
)
from longcat_video_tta_tpu_torch.models import clip, convert, xclip
from longcat_video_tta_tpu_torch.tta import clip_gate, split
from longcat_video_tta_tpu_torch.utils.safetensors import save_file

torch.set_num_threads(2)

TINY = dict(vocab=100, max_len=16, text_width=32, text_layers=2, text_heads=4,
            vision_width=32, vision_layers=2, vision_heads=4, patch=8, image=32, proj=24,
            frames=8, mit_layers=1, mit_heads=4, prompt_layers=2, prompt_heads=4)
VKW = dict(width=32, num_layers=2, num_heads=4, patch_size=8, image_size=32, projection_dim=24)
TKW = dict(vocab_size=100, width=32, num_layers=2, num_heads=4, max_length=16)
XKW = dict(num_frames=8, mit_layers=1, mit_heads=4, prompt_layers=2, prompt_heads=4)
CAPTION = "a ball moving across the scene"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _hf_config(xclip_model: bool):
    from transformers import CLIPConfig
    from transformers import XCLIPConfig as HFXConfig

    cfg = chip_smoke.clip_hf_config(TINY, xclip_model)
    cfg["text_config"]["eos_token_id"] = TINY["vocab"] - 1
    cls = HFXConfig if xclip_model else CLIPConfig
    kw = dict(prompt_hidden_act="quick_gelu") if xclip_model else {}
    return cls(**{k: v for k, v in cfg.items() if k not in ("architectures", "model_type")},
               **kw)


@pytest.fixture(scope="module")
def clip_sd():
    from transformers import CLIPModel

    torch.manual_seed(0)
    return {k: v.clone() for k, v in CLIPModel(_hf_config(False)).eval().state_dict().items()}


@pytest.fixture(scope="module")
def xclip_sd():
    from transformers import XCLIPModel

    torch.manual_seed(1)
    return {k: v.clone() for k, v in XCLIPModel(_hf_config(True)).eval().state_dict().items()}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def clip_pair(clip_sd):
    return (convert.convert_torch_clip_model_state(clip_sd, CLIPVisionConfig(**VKW),
                                                   CLIPTextConfig(**TKW)),
            jconvert.convert_torch_clip_model_state(_np(clip_sd), JVisionConfig(**VKW),
                                                    JTextConfig(**TKW)))


@pytest.fixture(scope="module")
def xclip_pair(xclip_sd):
    cfg = XCLIPConfig(vision=CLIPVisionConfig(**VKW), text=CLIPTextConfig(**TKW), **XKW)
    jcfg = JXConfig(vision=JVisionConfig(**VKW), text=JTextConfig(**TKW), **XKW)
    return (convert.convert_torch_xclip_state(xclip_sd, cfg),
            jconvert.convert_torch_xclip_state(_np(xclip_sd), jcfg), jcfg)


def _ids(n=2, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 98, size=(n, 16)).astype(np.int64)
    ids[:, 0] = 1
    ids[0, 10], ids[0, 11:] = 99, 0  # EOT = the vocab's last id: pooled at the argmax
    ids[1:, 14], ids[1:, 15:] = 99, 0
    return ids


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def test_synthetic_layouts_are_the_published_ones(clip_sd, xclip_sd):
    """chip_smoke's CLIP / X-CLIP checkpoint layouts against transformers'
    models at the same geometry (position_ids: a buffer older versions
    save and the converters ignore)."""
    for sd, xc in ((clip_sd, False), (xclip_sd, True)):
        ours = {k: s for k, s in chip_smoke.clip_state_shapes(TINY, xc).items()
                if not k.endswith("position_ids")}
        assert ours == {k: tuple(v.shape) for k, v in sd.items()
                        if not k.endswith("position_ids")}


def test_clip_image_embeds_match_jax(clip_pair):
    model, params = clip_pair
    pix = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32) * 0.5
    with torch.no_grad():
        port = model.image_embed(torch.from_numpy(pix)).numpy()
    ref = np.asarray(jclip.clip_image_embed(params, JVisionConfig(**VKW), jnp.asarray(pix)))
    assert port.shape == (3, 24) and _rel(port, ref) <= 1e-5


def test_clip_text_embeds_match_jax(clip_pair, clip_sd):
    """Causal, pooled at the argmax token; the text tower alone converts
    from a CLIPTextModel dict too."""
    model, params = clip_pair
    ids = _ids()
    with torch.no_grad():
        port = model.text_embed(torch.from_numpy(ids)).numpy()
        text_only = convert.convert_torch_clip_text_state(
            {k: v for k, v in clip_sd.items() if k.startswith("text_model.")},
            CLIPTextConfig(**TKW)).pooled(torch.from_numpy(ids)).numpy()
    ref = np.asarray(jclip.clip_text_embed(params, JTextConfig(**TKW),
                                           jnp.asarray(ids.astype(np.int32))))
    assert _rel(port, ref) <= 1e-5
    with torch.no_grad():
        np.testing.assert_array_equal(text_only,
                                      model.text.pooled(torch.from_numpy(ids)).numpy())
    # causal: a token after the EOT does not move the pooled state
    later = ids.copy()
    later[0, 12] = 50
    with torch.no_grad():
        moved = model.text_embed(torch.from_numpy(later)).numpy()
    np.testing.assert_array_equal(moved[0], port[0])


@pytest.mark.parametrize("hw", [(480, 832), (37, 61)], ids=["480x832", "odd"])
def test_preprocess_matches_jax(hw):
    frames = np.random.default_rng(3).random((4,) + hw + (3,), dtype=np.float32)
    size = 224 if hw[0] == 480 else 32
    port = clip.preprocess_frames(frames, size).numpy()
    ref = np.asarray(jclip.preprocess_frames(frames, size))
    assert port.shape == ref.shape == (4, size, size, 3)
    assert np.abs(port - ref).max() <= 1e-5


def test_clip_scorer_matches_jax(clip_pair):
    model, params = clip_pair
    tok = lambda c: clip.clip_hash_tokenize(c, 16, 100)
    np.testing.assert_array_equal(tok(CAPTION), jclip.clip_hash_tokenize(CAPTION, 16, 100))
    frames = np.random.default_rng(4).random((4, 48, 80, 3), dtype=np.float32)
    port = clip.make_tower_scorer(model, tok)(frames, CAPTION)
    ref = jclip.make_jax_clip_scorer(params, JVisionConfig(**VKW), JTextConfig(**TKW),
                                     tok)(frames, CAPTION)
    assert port.shape == (4,) and _rel(port, ref) <= 1e-5


def test_xclip_scores_match_jax(xclip_pair):
    model, params, jcfg = xclip_pair
    pix = np.random.RandomState(5).randn(2, 8, 32, 32, 3).astype(np.float32) * 0.5
    ids = _ids(3, seed=6)
    port = xclip.xclip_scores(model, torch.from_numpy(pix), torch.from_numpy(ids)).numpy()
    ref = np.asarray(jxclip.xclip_scores(params, jcfg, jnp.asarray(pix),
                                         jnp.asarray(ids.astype(np.int32))))
    assert port.shape == (2, 3) and np.abs(port - ref).max() <= 1e-5


@pytest.mark.parametrize("n", [5, 8, 11])
def test_xclip_scorer_pads_or_subsamples_as_jax(xclip_pair, n):
    model, params, jcfg = xclip_pair
    tok = lambda c: clip.clip_hash_tokenize(c, 16, 100)
    frames = np.random.default_rng(n).random((n, 40, 56, 3), dtype=np.float32)
    np.testing.assert_array_equal(clip.pad_or_subsample_frames(frames, 8),
                                  jclip.pad_or_subsample_frames(frames, 8))
    port = xclip.make_tower_scorer(model, tok)(frames, CAPTION)
    ref = jxclip.make_jax_xclip_scorer(params, jcfg, tok)(frames, CAPTION)
    assert port.shape == (1,) and np.abs(port - ref).max() <= 1e-5


@pytest.mark.parametrize("which", ["text", "clip", "xclip"])
def test_converters_refuse_unknown_and_missing_keys(clip_sd, xclip_sd, which):
    vcfg, tcfg = CLIPVisionConfig(**VKW), CLIPTextConfig(**TKW)
    fn = {"text": lambda sd: convert.convert_torch_clip_text_state(sd, tcfg),
          "clip": lambda sd: convert.convert_torch_clip_model_state(sd, vcfg, tcfg),
          "xclip": lambda sd: convert.convert_torch_xclip_state(
              sd, XCLIPConfig(vision=vcfg, text=tcfg, **XKW))}[which]
    sd = {k: v for k, v in (xclip_sd if which == "xclip" else clip_sd).items()
          if which != "text" or k.startswith("text_model.")}
    extra = "text_model.encoder.layers.2.mlp.fc1.weight"  # a third layer
    with pytest.raises(ValueError, match="unconsumed"):
        fn({**sd, extra: torch.zeros(3)})
    with pytest.raises(KeyError):
        fn({k: v for k, v in sd.items() if not k.endswith("final_layer_norm.bias")})


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


GATE_CASES = {
    "mean": dict(enabled=True),
    "min": dict(enabled=True, aggregate="min", threshold=0.0),
    "max": dict(enabled=True, aggregate="max", threshold=0.5),
    "late_only": dict(enabled=True, sampling_mode="late_only", late_fraction=0.3,
                      sample_frames=3),
    "log_only": dict(enabled=True, log_only=True, threshold=0.9),
    "fail_open": dict(enabled=True),
    "fail_closed": dict(enabled=True, fail_open=False),
    "no_scorer": dict(enabled=True, fail_open=False),
    "disabled": dict(enabled=False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_decisions_match_jax(case):
    """The same scorer through both gates: the same record and decision."""
    kw = GATE_CASES[case]
    frames = np.random.default_rng(7).random((13, 4, 4, 3))
    scores = np.linspace(-0.2, 0.6, 13)

    def scorer(sampled, caption):
        if case in ("fail_open", "fail_closed"):
            raise RuntimeError("scorer failed")
        return scores[[int(np.where((frames == f).all(axis=(1, 2, 3)))[0][0])
                       for f in sampled]]

    use = None if case == "no_scorer" else scorer
    port = clip_gate.evaluate_clip_gate(frames, CAPTION, ClipGateConfig(**kw), use)
    ref = jgate.evaluate_clip_gate(frames, CAPTION, JGateConfig(**kw), use)
    assert port == ref
    expect_skip = {"mean": True, "min": True, "max": False, "late_only": False,
                   "log_only": False, "fail_open": False, "fail_closed": True,
                   "no_scorer": True, "disabled": False}[case]
    assert port["skip_tta"] is expect_skip
    results = [port, {**port, "clip_gate_score": 0.1}]
    assert clip_gate.summarize_clip_gate_stats(results) == \
        jgate.summarize_clip_gate_stats(results)


def test_frame_offsets_match_jax():
    for window in (1, 3, 8, 13, 29):
        for kw in (dict(sample_frames=4), dict(sample_frames=8),
                   dict(sampling_mode="late_only", late_fraction=0.4),
                   dict(sampling_mode="late_only", late_fraction=0.0, sample_frames=2)):
            assert clip_gate.sample_clip_frame_offsets(window, ClipGateConfig(**kw)) == \
                jgate.sample_clip_frame_offsets(window, JGateConfig(**kw))


def _write_hf_dir(folder, sd, xclip_model: bool):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(chip_smoke.clip_hf_config(TINY, xclip_model), f)
    save_file({k: v.contiguous() for k, v in sd.items()},
              os.path.join(folder, "model.safetensors"))
    return folder


def test_make_clip_scorer_hash_tokenizer_opt_in(clip_sd, xclip_sd, tmp_path, monkeypatch):
    d = _write_hf_dir(str(tmp_path / "clip"), clip_sd, False)
    for make in (lambda: clip_gate.make_clip_scorer(d, "clip", "cpu"),
                 lambda: jgate.make_tpu_clip_scorer(d, "clip")):
        with pytest.raises(ValueError, match="hash tokenizer"):
            make()
    frames = np.random.default_rng(8).random((4, 48, 64, 3))
    port = clip_gate.make_clip_scorer(d, "clip", "cpu", allow_hash_tokenizer=True)
    ref = jgate.make_tpu_clip_scorer(d, "clip", allow_hash_tokenizer=True)
    assert _rel(port(frames, CAPTION), ref(frames, CAPTION)) <= 1e-5
    x = _write_hf_dir(str(tmp_path / "xclip"), xclip_sd, True)
    port = clip_gate.make_clip_scorer(x, "xclip", "cpu", allow_hash_tokenizer=True)
    ref = jgate.make_tpu_clip_scorer(x, "xclip", allow_hash_tokenizer=True)
    assert np.abs(port(frames, CAPTION) - ref(frames, CAPTION)).max() <= 1e-5
    # tokenizer files but no transformers: raise, never fall back to hash ids
    open(os.path.join(d, "vocab.json"), "w").close()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        clip_gate.make_clip_scorer(d, "clip", "cpu", allow_hash_tokenizer=True)
    with pytest.raises(RuntimeError, match="transformers"):
        clip_gate.make_hf_clip_scorer(d)
    if not torch.cuda.is_available():  # the scorer defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            clip_gate.make_clip_scorer(x, "xclip", allow_hash_tokenizer=True)


@pytest.mark.parametrize("gate", [dict(enabled=True, backend="xclip"),
                                  dict(enabled=True, sample_frames=6,
                                       sampling_mode="late_only", late_fraction=0.4),
                                  dict(enabled=True), dict(enabled=False)],
                         ids=["xclip", "late_only", "clip", "off"])
def test_feature_budget_gate_check_matches_jax(gate):
    fkw = dict(num_cond_frames=5, tta_total_frames=5, gen_start_frame=16)
    frames = split.resolve_frame_window(FrameConfig(**fkw))
    jframes = jsplit.resolve_frame_window(JFrameConfig(**fkw))
    es, jes = EarlyStoppingConfig(enabled=False), JESConfig(enabled=False)
    outcome = []
    for fn in (lambda: split.validate_tta_feature_budget(
                   frames, es, "fail", clip_gate=ClipGateConfig(**gate)),
               lambda: jsplit.validate_tta_feature_budget(
                   jframes, jes, JGateConfig(**gate), "fail")):
        try:
            outcome.append(fn())
        except RuntimeError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    if gate.get("backend") == "xclip":
        assert "required=8" in outcome[0]
