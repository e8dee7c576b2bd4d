"""Synthetic-weight metric and gate towers in the on-disk formats the
runner's loaders read (counterpart of the repository's
``scripts/make_synth_towers.py``), drawn from a ``torch.Generator``, so a
campaign on a machine with no network runs every quality tower: LPIPS,
online FVD / FID, the CLIP gate and the native VBench dimensions. The
numbers compare rows of one campaign (same towers), never published
scores; the folder carries a ``SYNTHETIC_WEIGHTS`` marker.

Layout produced (the reference script's file names and geometries):
    lpips_alex.pth           -> --lpips-model-path
    i3d.pth                  -> --fvd-enabled --i3d-model-path
    inception_v3.pth         -> --inception-model-path
    clip/                    -> --clip-gate-model-path (hash tokenizer):
                                CLIP width 128, 2 layers, 4 heads, proj 64
    dino_vits16.pth (+json)  -> --vbench-towers-dir: width 64, 2 layers,
                                2 heads, patch 16
    aesthetic_l14.pth + clip_l14/ -> --vbench-towers-dir: the LAION head
                                (64 -> 128 -> 64 -> 16 -> 8 -> 1) on a
                                clip/-geometry CLIP
    musiq_spaq.pth (+json)   -> --vbench-towers-dir (imaging_quality)
LPIPS, I3D and InceptionV3 are at their published geometry. The shape
tables and ``write_tower_files`` / ``write_vbench_tower_files`` (which
also write the published geometries, and X-CLIP) are the writers
``chip_smoke.py`` uses too.

Usage:
    python3 -m longcat_video_tta_tpu_torch.scripts.make_synth_towers \
        --out-dir campaign/towers_torch [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

CLIP_GEOMETRY = dict(vocab=49408, max_len=77, text_width=512, text_layers=12, text_heads=8,
                     vision_width=768, vision_layers=12, vision_heads=12, patch=32,
                     image=224, proj=512, frames=8, mit_layers=1, mit_heads=8,
                     prompt_layers=2, prompt_heads=8)
# lpips.LPIPS(net='alex'): (torchvision features index, cout, cin, kernel)
LPIPS_CONVS = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
               (10, 256, 256, 3))
# pytorch-i3d InceptionI3d: module -> (cin, b0, b1 reduce, b1, b2 reduce, b2, b3)
I3D_MODULES = {"Mixed_3b": (192, 64, 96, 128, 16, 32, 32),
               "Mixed_3c": (256, 128, 128, 192, 32, 96, 64),
               "Mixed_4b": (480, 192, 96, 208, 16, 48, 64),
               "Mixed_4c": (512, 160, 112, 224, 24, 64, 64),
               "Mixed_4d": (512, 128, 128, 256, 24, 64, 64),
               "Mixed_4e": (512, 112, 144, 288, 32, 64, 64),
               "Mixed_4f": (528, 256, 160, 320, 32, 128, 128),
               "Mixed_5b": (832, 256, 160, 320, 32, 128, 128),
               "Mixed_5c": (832, 384, 192, 384, 48, 128, 128)}

def clip_hf_config(g, xclip: bool) -> dict:
    """config.json of the published checkpoint (the keys the loaders read)."""
    text = {"vocab_size": g["vocab"], "hidden_size": g["text_width"],
            "intermediate_size": 4 * g["text_width"], "num_hidden_layers": g["text_layers"],
            "num_attention_heads": g["text_heads"], "max_position_embeddings": g["max_len"],
            "hidden_act": "quick_gelu"}
    vision = {"hidden_size": g["vision_width"], "intermediate_size": 4 * g["vision_width"],
              "num_hidden_layers": g["vision_layers"],
              "num_attention_heads": g["vision_heads"], "patch_size": g["patch"],
              "image_size": g["image"], "hidden_act": "quick_gelu"}
    cfg = {"projection_dim": g["proj"], "text_config": text, "vision_config": vision}
    if not xclip:
        return dict(cfg, architectures=["CLIPModel"], model_type="clip")
    vision.update(num_frames=g["frames"], mit_hidden_size=g["proj"],
                  mit_intermediate_size=4 * g["proj"],
                  mit_num_hidden_layers=g["mit_layers"],
                  mit_num_attention_heads=g["mit_heads"])
    return dict(cfg, architectures=["XCLIPModel"], model_type="xclip",
                prompt_layers=g["prompt_layers"],
                prompt_num_attention_heads=g["prompt_heads"])


def _hf_layer(prefix: str, width: int, table) -> dict:
    out = {}
    for name, dims in table:
        if dims == "ln":
            out.update({f"{prefix}.{name}.weight": (width,), f"{prefix}.{name}.bias": (width,)})
        else:
            i, o, bias = dims
            out[f"{prefix}.{name}.weight"] = (o * width, i * width)
            if bias:
                out[f"{prefix}.{name}.bias"] = (o * width,)
    return out


_HF_ATTN = [(f"self_attn.{n}_proj", (1, 1, True)) for n in "kvq"] + [
    ("self_attn.out_proj", (1, 1, True)), ("layer_norm1", "ln"),
    ("mlp.fc1", (1, 4, True)), ("mlp.fc2", (4, 1, True)), ("layer_norm2", "ln")]
_HF_MSG = [("message_fc", (1, 1, True)), ("message_ln", "ln")] + [
    (f"message_attn.{n}_proj", (1, 1, True)) for n in ("k", "v", "q", "out")]


def clip_state_shapes(g, xclip: bool) -> dict:
    """key -> shape of a Hugging Face CLIPModel / XCLIPModel checkpoint."""
    T, V, P = g["text_width"], g["vision_width"], g["proj"]
    n_patch = (g["image"] // g["patch"]) ** 2 + 1
    sh = {"logit_scale": (),
          "text_model.embeddings.token_embedding.weight": (g["vocab"], T),
          "text_model.embeddings.position_embedding.weight": (g["max_len"], T),
          "text_model.embeddings.position_ids": (1, g["max_len"]),
          "text_model.final_layer_norm.weight": (T,), "text_model.final_layer_norm.bias": (T,),
          "vision_model.embeddings.class_embedding": (V,),
          "vision_model.embeddings.patch_embedding.weight": (V, 3, g["patch"], g["patch"]),
          "vision_model.embeddings.position_embedding.weight": (n_patch, V),
          "vision_model.embeddings.position_ids": (1, n_patch),
          "vision_model.post_layernorm.weight": (V,), "vision_model.post_layernorm.bias": (V,),
          "visual_projection.weight": (P, V), "text_projection.weight": (P, T)}
    pre = "pre_layernorm" if xclip else "pre_layrnorm"
    sh.update({f"vision_model.{pre}.weight": (V,), f"vision_model.{pre}.bias": (V,)})
    for i in range(g["text_layers"]):
        sh.update(_hf_layer(f"text_model.encoder.layers.{i}", T, _HF_ATTN))
    for i in range(g["vision_layers"]):
        sh.update(_hf_layer(f"vision_model.encoder.layers.{i}", V,
                            (_HF_MSG if xclip else []) + _HF_ATTN))
    if not xclip:
        return sh
    sh.update({"prompts_visual_projection": (V, P),
               "prompts_visual_layernorm.weight": (V,), "prompts_visual_layernorm.bias": (V,),
               "mit.position_embedding": (1, g["frames"], P),
               "prompts_generator.alpha": (P,),
               "prompts_generator.layernorm.weight": (P,),
               "prompts_generator.layernorm.bias": (P,)})
    for i in range(g["mit_layers"]):
        sh.update(_hf_layer(f"mit.encoder.layers.{i}", P, _HF_ATTN))
    for i in range(g["prompt_layers"]):
        sh.update(_hf_layer(f"prompts_generator.decoder.{i}", P, [
            ("cross_attn.q_proj", (1, 1, False)), ("cross_attn.k_proj", (1, 1, False)),
            ("cross_attn.v_proj", (1, 1, False)), ("cross_attn.proj", (1, 1, True)),
            ("norm1", "ln"), ("norm3", "ln"), ("mlp.0", (1, 4, True)),
            ("mlp.3", (4, 1, True))]))
    return sh


def lpips_state_shapes() -> dict:
    sh = {"scaling_layer.shift": (1, 3, 1, 1), "scaling_layer.scale": (1, 3, 1, 1)}
    for i, (idx, cout, cin, k) in enumerate(LPIPS_CONVS):
        sh[f"net.slice{i + 1}.{idx}.weight"] = (cout, cin, k, k)
        sh[f"net.slice{i + 1}.{idx}.bias"] = (cout,)
        sh[f"lin{i}.model.1.weight"] = (1, cout, 1, 1)
    return sh


def _bn_unit(prefix: str, conv: str, cout: int, kernel: tuple, cin: int) -> dict:
    sh = {f"{prefix}.{conv}.weight": (cout, cin) + kernel,
          f"{prefix}.bn.num_batches_tracked": ()}
    sh.update({f"{prefix}.bn.{k}": (cout,)
               for k in ("weight", "bias", "running_mean", "running_var")})
    return sh


def i3d_state_shapes() -> dict:
    """The pytorch-i3d InceptionI3d state dict (Kinetics-400 logits)."""
    sh = {}
    for name, cin, cout, k in (("Conv3d_1a_7x7", 3, 64, 7), ("Conv3d_2b_1x1", 64, 64, 1),
                               ("Conv3d_2c_3x3", 64, 192, 3)):
        sh.update(_bn_unit(name, "conv3d", cout, (k,) * 3, cin))
    for name, (cin, b0, b1r, b1, b2r, b2, b3) in I3D_MODULES.items():
        for unit, i, o, k in (("b0", cin, b0, 1), ("b1a", cin, b1r, 1), ("b1b", b1r, b1, 3),
                              ("b2a", cin, b2r, 1), ("b2b", b2r, b2, 3), ("b3b", cin, b3, 1)):
            sh.update(_bn_unit(f"{name}.{unit}", "conv3d", o, (k,) * 3, i))
    sh.update({"logits.conv3d.weight": (400, 1024, 1, 1, 1), "logits.conv3d.bias": (400,)})
    return sh


def inception_state_shapes() -> dict:
    """torchvision's inception_v3 state dict, AuxLogits and fc included."""
    units = [("Conv2d_1a_3x3", 3, 32, (3, 3)), ("Conv2d_2a_3x3", 32, 32, (3, 3)),
             ("Conv2d_2b_3x3", 32, 64, (3, 3)), ("Conv2d_3b_1x1", 64, 80, (1, 1)),
             ("Conv2d_4a_3x3", 80, 192, (3, 3))]
    for name, cin, pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                            ("Mixed_5d", 288, 64)):
        units += [(f"{name}.{b}", i, o, k) for b, i, o, k in (
            ("branch1x1", cin, 64, (1, 1)), ("branch5x5_1", cin, 48, (1, 1)),
            ("branch5x5_2", 48, 64, (5, 5)), ("branch3x3dbl_1", cin, 64, (1, 1)),
            ("branch3x3dbl_2", 64, 96, (3, 3)), ("branch3x3dbl_3", 96, 96, (3, 3)),
            ("branch_pool", cin, pool, (1, 1)))]
    units += [(f"Mixed_6a.{b}", i, o, k) for b, i, o, k in (
        ("branch3x3", 288, 384, (3, 3)), ("branch3x3dbl_1", 288, 64, (1, 1)),
        ("branch3x3dbl_2", 64, 96, (3, 3)), ("branch3x3dbl_3", 96, 96, (3, 3)))]
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        units += [(f"{name}.{b}", i, o, k) for b, i, o, k in (
            ("branch1x1", 768, 192, (1, 1)), ("branch7x7_1", 768, c7, (1, 1)),
            ("branch7x7_2", c7, c7, (1, 7)), ("branch7x7_3", c7, 192, (7, 1)),
            ("branch7x7dbl_1", 768, c7, (1, 1)), ("branch7x7dbl_2", c7, c7, (7, 1)),
            ("branch7x7dbl_3", c7, c7, (1, 7)), ("branch7x7dbl_4", c7, c7, (7, 1)),
            ("branch7x7dbl_5", c7, 192, (1, 7)), ("branch_pool", 768, 192, (1, 1)))]
    units += [(f"Mixed_7a.{b}", i, o, k) for b, i, o, k in (
        ("branch3x3_1", 768, 192, (1, 1)), ("branch3x3_2", 192, 320, (3, 3)),
        ("branch7x7x3_1", 768, 192, (1, 1)), ("branch7x7x3_2", 192, 192, (1, 7)),
        ("branch7x7x3_3", 192, 192, (7, 1)), ("branch7x7x3_4", 192, 192, (3, 3)))]
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        units += [(f"{name}.{b}", i, o, k) for b, i, o, k in (
            ("branch1x1", cin, 320, (1, 1)), ("branch3x3_1", cin, 384, (1, 1)),
            ("branch3x3_2a", 384, 384, (1, 3)), ("branch3x3_2b", 384, 384, (3, 1)),
            ("branch3x3dbl_1", cin, 448, (1, 1)), ("branch3x3dbl_2", 448, 384, (3, 3)),
            ("branch3x3dbl_3a", 384, 384, (1, 3)), ("branch3x3dbl_3b", 384, 384, (3, 1)),
            ("branch_pool", cin, 192, (1, 1)))]
    units += [("AuxLogits.conv0", 768, 128, (1, 1)), ("AuxLogits.conv1", 128, 768, (5, 5))]
    sh = {}
    for name, cin, cout, k in units:
        sh.update(_bn_unit(name, "conv", cout, k, cin))
    sh.update({"AuxLogits.fc.weight": (1000, 768), "AuxLogits.fc.bias": (1000,),
               "fc.weight": (1000, 2048), "fc.bias": (1000,)})
    return sh


def tower_value(key: str, shape, gen, device):
    """A drawn value for one checkpoint tensor, by its role: integer
    buffers count, norm scales near 1, running variances in [1, 1.1),
    biases and running means small, convolutions He-scaled, linears
    1/sqrt(fan-in), embeddings 0.02, LPIPS' 1x1 weights non-negative."""
    if key.endswith("position_ids"):
        return torch.arange(shape[-1], device=device).view(shape)
    if key.endswith("num_batches_tracked"):
        return torch.zeros(shape, dtype=torch.long, device=device)
    if key == "logit_scale":
        return torch.full(shape, math.log(1 / 0.07), device=device)
    if key.startswith("scaling_layer."):
        c = (-0.030, -0.088, -0.188) if key.endswith("shift") else (0.458, 0.448, 0.450)
        return torch.tensor(c, device=device).view(shape)
    r = torch.randn(shape, generator=gen, device=device)
    if key.endswith("running_var"):
        return 1.0 + 0.1 * torch.rand(shape, generator=gen, device=device)
    if key.endswith(("running_mean", ".bias")):
        return 0.02 * r
    if key.startswith("lin") or key == "prompts_generator.alpha":
        return 0.1 * r.abs()
    if "embedding" in key:
        return 0.02 * r
    if len(shape) == 1:  # layer / batch norm scales
        return 1.0 + 0.02 * r
    fan_in = math.prod(shape[1:]) if key != "prompts_visual_projection" else shape[0]
    return r * math.sqrt((2.0 if len(shape) > 2 else 1.0) / fan_in)


def _drawer(seed: int, device):
    """shapes -> drawn tensors (``tower_value``), from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda shapes: {k: tower_value(k, s, gen, device) for k, s in shapes.items()}


def write_clip_dir(folder: str, g: dict, xclip: bool, draw) -> str:
    """A CLIP (or X-CLIP) tower at geometry ``g`` as a Hugging Face folder
    (config.json + model.safetensors, no tokenizer). Returns the folder."""
    from ..utils.safetensors import save_file

    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(clip_hf_config(g, xclip), f)
    save_file(draw(clip_state_shapes(g, xclip)), os.path.join(folder, "model.safetensors"))
    return folder


def write_state_dict_towers(folder: str, draw) -> dict:
    """LPIPS, I3D and InceptionV3 as torch state-dict files (lpips_alex.pth,
    i3d.pth, inception_v3.pth). Returns {tower: path}."""
    paths = {}
    for name, file, shapes in (("lpips", "lpips_alex.pth", lpips_state_shapes()),
                               ("i3d", "i3d.pth", i3d_state_shapes()),
                               ("inception", "inception_v3.pth", inception_state_shapes())):
        paths[name] = os.path.join(folder, file)
        torch.save({k: v.cpu() for k, v in draw(shapes).items()}, paths[name])
    return paths


def write_tower_files(folder: str, seed: int, device="cuda", clip_geometry=None) -> dict:
    """The five tower checkpoints, drawn from ``seed`` on ``device`` in
    their published layouts: CLIP and X-CLIP folders at ``clip_geometry``
    (default the published one), then LPIPS, I3D and InceptionV3. Returns
    {tower: path}."""
    g = clip_geometry or CLIP_GEOMETRY
    draw = _drawer(seed, device)
    paths = {name: write_clip_dir(os.path.join(folder, name), g, name == "xclip", draw)
             for name in ("clip", "xclip")}
    paths.update(write_state_dict_towers(folder, draw))
    return paths


# the VBench towers at their published geometry: DINO ViT-S/16, CLIP
# ViT-L/14 with the LAION aesthetic head, MUSIQ-SPAQ
CLIP_L14_GEOMETRY = dict(vocab=49408, max_len=77, text_width=768, text_layers=12,
                         text_heads=12, vision_width=1024, vision_layers=24,
                         vision_heads=16, patch=14, image=224, proj=768)
# the predictor's widths after the 768-d CLIP-L/14 embed; its nn.Sequential
# holds the Linears at 0, 2, 4, 6, 7 (Dropouts between)
AESTHETIC_DIMS = (1024, 128, 64, 16, 1)
AESTHETIC_LAYERS = (0, 2, 4, 6, 7)


def _vit_block_shapes(prefix: str, W: int) -> dict:
    sh = {}
    for name, shape in (("norm1", (W,)), ("norm2", (W,))):
        sh.update({f"{prefix}.{name}.weight": shape, f"{prefix}.{name}.bias": shape})
    for name, o, i in (("attn.qkv", 3 * W, W), ("attn.proj", W, W),
                       ("mlp.fc1", 4 * W, W), ("mlp.fc2", W, 4 * W)):
        sh.update({f"{prefix}.{name}.weight": (o, i), f"{prefix}.{name}.bias": (o,)})
    return sh


def dino_state_shapes(d: dict) -> dict:
    """key -> shape of the facebookresearch/dino ``dino_vits16`` state dict
    at geometry ``d`` (width, num_layers, num_heads, patch_size, image_size)."""
    W, p = d["width"], d["patch_size"]
    sh = {"cls_token": (1, 1, W), "pos_embed": (1, (d["image_size"] // p) ** 2 + 1, W),
          "patch_embed.proj.weight": (W, 3, p, p), "patch_embed.proj.bias": (W,),
          "norm.weight": (W,), "norm.bias": (W,)}
    for i in range(d["num_layers"]):
        sh.update(_vit_block_shapes(f"blocks.{i}", W))
    return sh


def musiq_state_shapes(m: dict) -> dict:
    """key -> shape of a MUSIQ state dict in the reference's layout at
    geometry ``m`` (MUSIQConfig.as_dict())."""
    W, G, p = m["width"], m["grid_size"], m["patch_size"]
    sh = {"patch_embedding.weight": (W, 3 * p * p), "patch_embedding.bias": (W,),
          "cls_token": (1, 1, W), "hash_pos_embed": (G, G, W),
          "scale_embed": (1 + len(m["longer_sides"]), W),
          "norm.weight": (W,), "norm.bias": (W,), "head.weight": (1, W), "head.bias": (1,)}
    for i in range(m["num_layers"]):
        sh.update(_vit_block_shapes(f"blocks.{i}", W))
    return sh


def write_vbench_tower_files(folder: str, seed: int, device="cuda", dino=None, musiq=None,
                             clip_geometry=None, aesthetic_dims=AESTHETIC_DIMS) -> dict:
    """The VBench towers' files, drawn from ``seed`` on ``device``:
    dino_vits16.pth and musiq_spaq.pth (each with its config sidecar),
    aesthetic_l14.pth (the predictor's Sequential keys) and clip_l14/ (a
    Hugging Face CLIPModel folder without a tokenizer). ``dino`` /
    ``musiq`` / ``clip_geometry`` override the published geometries (the
    CPU tests' tiny towers; ``aesthetic_dims`` the head's widths after
    the CLIP embed). Returns {tower: path}."""
    import dataclasses

    from ..eval.musiq import MUSIQConfig
    from ..eval.vbench_native import DINOViTConfig
    from ..utils.safetensors import save_file

    dino = dino or dataclasses.asdict(DINOViTConfig())
    musiq = musiq or MUSIQConfig().as_dict()
    g = clip_geometry or CLIP_L14_GEOMETRY
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda shapes: {k: tower_value(k, s, gen, device).cpu() for k, s in shapes.items()}
    os.makedirs(folder, exist_ok=True)
    paths = {}
    for name, file, shapes, side in (("dino", "dino_vits16.pth", dino_state_shapes(dino),
                                      ("dino_config.json", dino)),
                                     ("musiq", "musiq_spaq.pth", musiq_state_shapes(musiq),
                                      ("musiq_config.json", musiq))):
        paths[name] = os.path.join(folder, file)
        torch.save(draw(shapes), paths[name])
        with open(os.path.join(folder, side[0]), "w") as f:
            json.dump(side[1], f)
    dims = (g["proj"],) + tuple(aesthetic_dims)
    paths["aesthetic"] = os.path.join(folder, "aesthetic_l14.pth")
    torch.save(draw({f"layers.{i}.{n}": ((o, a) if n == "weight" else (o,))
                     for i, a, o in zip(AESTHETIC_LAYERS, dims[:-1], dims[1:])
                     for n in ("weight", "bias")}), paths["aesthetic"])
    paths["clip_l14"] = os.path.join(folder, "clip_l14")
    os.makedirs(paths["clip_l14"], exist_ok=True)
    with open(os.path.join(paths["clip_l14"], "config.json"), "w") as f:
        json.dump(clip_hf_config(g, False), f)
    save_file(draw(clip_state_shapes(g, False)),
              os.path.join(paths["clip_l14"], "model.safetensors"))
    return paths


# the reference script's synthetic geometries (scripts/make_synth_towers.py
# make_clip_dir, make_dino, make_aesthetic, test_musiq.TINY)
SYNTH_CLIP = dict(vocab=49408, max_len=77, text_width=128, text_layers=2, text_heads=4,
                  vision_width=128, vision_layers=2, vision_heads=4, patch=32, image=224,
                  proj=64)
SYNTH_DINO = dict(width=64, num_layers=2, num_heads=2, patch_size=16, image_size=224)
SYNTH_MUSIQ = dict(width=32, num_layers=2, num_heads=2, patch_size=8, grid_size=4,
                   longer_sides=(16, 24), max_tokens=48)
SYNTH_AESTHETIC_DIMS = (128, 64, 16, 8, 1)


def make_synth_towers(out_dir: str, seed: int = 0, device="cuda") -> dict:
    """The seven synthetic towers under ``out_dir`` and the
    SYNTHETIC_WEIGHTS marker. Returns {tower: path}."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    draw = _drawer(seed, device)
    paths = {"clip": write_clip_dir(os.path.join(out_dir, "clip"), SYNTH_CLIP, False, draw)}
    paths.update(write_state_dict_towers(out_dir, draw))
    vb = write_vbench_tower_files(out_dir, seed + 1, device, dino=SYNTH_DINO,
                                  musiq=SYNTH_MUSIQ, clip_geometry=SYNTH_CLIP,
                                  aesthetic_dims=SYNTH_AESTHETIC_DIMS)
    paths.update({"dino": vb["dino"], "aesthetic": vb["aesthetic"], "musiq": vb["musiq"]})
    with open(os.path.join(out_dir, "SYNTHETIC_WEIGHTS"), "w") as f:
        f.write("Towers in this dir carry seeded RANDOM weights made by "
                "longcat_video_tta_tpu_torch/scripts/make_synth_towers.py.\n"
                "Scores are comparable across rows of the same campaign, not "
                "against published numbers.\n")
    return paths


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="write synthetic-weight metric and gate towers")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the weights are drawn: cuda (default; raises without a "
                        "GPU) or cpu")
    args = p.parse_args(argv)
    made = make_synth_towers(args.out_dir, args.seed, args.device)
    for name, path in made.items():
        print(f"[synth_towers] {name}: {path}")
    return made


if __name__ == "__main__":
    main()
