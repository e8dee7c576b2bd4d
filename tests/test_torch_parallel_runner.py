"""The runner's and the sweep's mesh flags on the port (runners/run_tta.py,
sweep/run_sweep.py), on the CPU.

- The reference runner's refusals (:746-794, :831-840, :1009) and the
  world-size rule; 0 and 1 mean no mesh.
- delta_a on longcat_tiny through torchrun (2 gloo ranks, counted by
  tests/torch_parallel_worker.py's runner mode): --context-mesh 2 and
  --tensor-mesh 2 equal one rank, --video-parallel 2 --data-mesh 2 equals
  one rank's --video-parallel 2, within 1e-4 (losses, anchors, PSNR, the
  best step); each rank's plain-path attention calls equal
  chip_smoke.mesh_launches (what the kernels launch on the card); rank 0
  alone calls the output writers.
- --checkpoint-dir under --tensor-mesh 2: each DiT tensor is read,
  sliced to the rank's share and dropped (the share equals the slice of
  the whole loaded model, bit for bit), and the run equals one rank on
  the same folder within 1e-4.
- A sweep row with context_mesh 2 runs as torchrun's 2 processes.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from longcat_video_tta_tpu_torch.runners import run_tta

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
STEPS, CHECK, INFER, DEPTH = 4, 2, 2, 2  # longcat_tiny: 2 blocks
BASE = ["--method", "delta_a", "--preset", "longcat_tiny", "--device", "cpu",
        "--height", "16", "--width", "32", "--num-cond-frames", "5", "--num-frames", "5",
        "--gen-start-frame", "16", "--tta-total-frames", "13", "--steps", str(STEPS),
        "--es-check-every", str(CHECK), "--es-patience", "3",
        "--num-inference-steps", str(INFER), "--caption-guard-mode", "off"]
TOL = dict(rel=1e-4, abs=1e-6)


def _argv(out, *extra, videos=1):
    return BASE + ["--synthetic", str(videos), "--output-dir", str(out), *extra]


def _torchrun(out_json, argv, ranks=2):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(ranks), WORKER, "runner", str(out_json),
                        *argv], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return [json.load(open(f"{out_json}.{rank}")) for rank in range(ranks)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank's runs in this process; the mesh runs as torchrun ranks."""
    base = tmp_path_factory.mktemp("mesh_runs")
    out = {"one": run_tta.main(_argv(base / "one", "--save-adapters")),
           "vp": run_tta.main(_argv(base / "vp", "--video-parallel", "2", videos=2))}
    out["cp"] = _torchrun(base / "cp.json", _argv(base / "cp", "--context-mesh", "2",
                                                  "--save-adapters"))
    out["tp"] = _torchrun(base / "tp.json", _argv(base / "tp", "--tensor-mesh", "2"))
    out["dp"] = _torchrun(base / "dp.json", _argv(base / "dp", "--video-parallel", "2",
                                                  "--data-mesh", "2", videos=2))
    out["dirs"] = {k: base / k for k in ("one", "vp", "cp", "tp", "dp")}
    return out


def _same_video(a, b, scored=True):
    """``a`` equals ``b``; ``scored`` False: a context or tensor rank other
    than 0, which leaves the decode and the metrics to rank 0."""
    assert a["success"] and b["success"], (a.get("error"), b.get("error"))
    assert a["losses"] == pytest.approx(b["losses"], **TOL)
    ea, eb = a["early_stopping_info"], b["early_stopping_info"]
    assert ea["best_step"] == eb["best_step"]
    assert [x[1] for x in ea["loss_history"]] == pytest.approx(
        [x[1] for x in eb["loss_history"]], **TOL)
    if scored:
        assert a["psnr"] == pytest.approx(b["psnr"], **TOL)
    else:
        assert "psnr" not in a
    assert a["adapter_norm"] == pytest.approx(b["adapter_norm"], rel=1e-3)


@pytest.mark.parametrize("kind", ["context", "tensor"])
def test_mesh_run_equals_one_rank(runs, kind):
    """2 ranks (context or tensor) against one rank on the same seed; each
    rank's launches as ``mesh_launches`` derives them; rank 0 alone decodes
    and scores the clip (the ranks hold the same latents)."""
    ranks = runs["cp" if kind == "context" else "tp"]
    ref = runs["one"]["results"][0]
    for rank, rec in enumerate(ranks):
        r = rec["summary"]["results"][0]
        _same_video(r, ref, scored=rank == 0)
        checks = len(r["early_stopping_info"]["loss_history"])
        assert rec["launches"] == chip_smoke.mesh_launches(
            kind, DEPTH, 2, steps=len(r["losses"]), anchors=checks, inference_steps=INFER)


def test_data_mesh_run_equals_video_parallel(runs):
    """--video-parallel 2 --data-mesh 2: each rank trains and generates one
    lane; rank 0's summary holds both videos, each equal to one rank's
    --video-parallel 2 run."""
    ref = runs["vp"]["results"]
    got = runs["dp"][0]["summary"]["results"]
    assert [r["index"] for r in got] == [0, 1]
    for a, b in zip(got, ref):
        _same_video(a, b)
    for rec in runs["dp"]:
        assert rec["launches"] == chip_smoke.mesh_launches(
            "data", DEPTH, 2, steps=STEPS, anchors=0, inference_steps=INFER, lanes=1,
            checks=STEPS // CHECK)
    assert sorted(os.listdir(runs["dirs"]["dp"] / "videos")) == sorted(
        os.listdir(runs["dirs"]["vp"] / "videos"))


def test_only_rank_zero_writes(runs):
    """Rank 0 writes config.json (with the backend, world and mesh),
    summary.json, the checkpoint, the clips and the adapters; the other
    rank writes nothing."""
    for kind in ("cp", "tp", "dp"):
        r0, r1 = runs[kind]
        assert r1["writes"] == [], kind
        for name in ("save_config", "save_results", "save_checkpoint", "save_video",
                     "make_synthetic_dataset"):
            assert name in r0["writes"], (kind, name)
    assert "save_adapter_state" in runs["cp"][0]["writes"]
    with open(runs["dirs"]["cp"] / "config.json") as f:
        mesh = json.load(f)["mesh"]
    assert mesh["backend"] == "gloo" and mesh["world"] == 2 and mesh["rank"] == 0
    assert mesh["mesh"] == {"data": 1, "context": 2, "tensor": 1}
    saved = torch.load(runs["dirs"]["cp"] / "adapters" / "0000_clip_000.npy.pt")
    ref = torch.load(runs["dirs"]["one"] / "adapters" / "0000_clip_000.npy.pt")
    torch.testing.assert_close(saved["delta"], ref["delta"], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("extra,match", [
    (["--context-mesh", "2", "--video-parallel", "2"], "mutually exclusive"),
    (["--tensor-mesh", "2", "--video-parallel", "2"], "mutually exclusive"),
    (["--context-mesh", "2", "--bsa-keep-ratio", "0.5"], "--bsa-keep-ratio"),
    (["--tensor-mesh", "2", "--quantize-decode", "int8qk"], "int8qk"),
    (["--context-mesh", "2", "--preset", "opensora_v2_tiny"], "LongCat backbone only"),
    (["--context-mesh", "3"], "spatial token count"),
    (["--tensor-mesh", "3"], "must divide num_heads"),
    (["--context-mesh", "2", "--method", "dno"], "dno does not compose with --context-mesh"),
    (["--tensor-mesh", "2", "--method", "dno"], "dno does not compose with --tensor-mesh"),
    (["--data-mesh", "2"], "requires --video-parallel"),
    (["--context-mesh", "2"], "launch with torchrun"),
], ids=["cp_vp", "tp_vp", "cp_bsa", "tp_int8qk", "cp_mmdit", "cp_nhw", "tp_heads",
        "dno_cp", "dno_tp", "dp_no_vp", "no_process_group"])
def test_mesh_refusals(tmp_path, monkeypatch, extra, match):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(SystemExit, match=match):
        run_tta.main(_argv(tmp_path / "r", *extra))


def test_world_size_must_equal_the_mesh(tmp_path):
    """A process group of 1 rank cannot hold --context-mesh 2 x
    --tensor-mesh 2."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                            rank=0)
    try:
        with pytest.raises(SystemExit, match="needs 4 ranks; this launch has 1"):
            run_tta.main(_argv(tmp_path / "r", "--context-mesh", "2", "--tensor-mesh", "2"))
    finally:
        dist.destroy_process_group()


def test_zero_and_one_mean_no_mesh(runs, tmp_path):
    """--data-mesh 1 --context-mesh 1 --tensor-mesh 0 is the one-rank run
    (the reference takes max(1, n))."""
    s = run_tta.main(_argv(tmp_path / "r", "--data-mesh", "1", "--context-mesh", "1",
                           "--tensor-mesh", "0"))
    assert s["results"][0]["losses"] == runs["one"]["results"][0]["losses"]
    with open(tmp_path / "r" / "config.json") as f:
        assert json.load(f)["mesh"] is None


def _checkpoint_dir(root):
    """A longcat_tiny folder of dit/, vae/ and text_encoder/ safetensors
    shards in the upstream layout (tests/synth_checkpoints.py)."""
    import safetensors.numpy

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from synth_checkpoints import make_dit_sd, make_umt5_sd, make_vae_sd

    from longcat_video_tta_tpu_torch.config import get_model_config

    cfg = get_model_config("longcat_tiny")
    for name, sd in (("dit", make_dit_sd(cfg.dit, 6)), ("vae", make_vae_sd(cfg.vae, 6)),
                     ("text_encoder", make_umt5_sd(cfg.text, 6))):
        os.makedirs(os.path.join(root, name))
        safetensors.numpy.save_file(sd, os.path.join(root, name, "m-0.safetensors"))
    return cfg


def test_tensor_mesh_loads_its_share_of_a_checkpoint(tmp_path, monkeypatch):
    """--checkpoint-dir --tensor-mesh 2: each rank's DiT is read tensor by
    tensor into its shares (every tensor the loader writes is one the
    rank keeps; each share equals the slice of the whole loaded DiT), and
    the torchrun run equals one rank on the same folder."""
    from longcat_video_tta_tpu_torch.config import MeshConfig
    from longcat_video_tta_tpu_torch.models import weights
    from longcat_video_tta_tpu_torch.parallel.mesh import Mesh
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle

    ckpt = str(tmp_path / "ckpt")
    cfg = _checkpoint_dir(ckpt)
    whole = ModelBundle.from_checkpoint_dir(cfg, ckpt, "cpu").dit
    written, set_ = [], weights._set

    def spy(param, value):
        written.append(param)
        set_(param, value)

    monkeypatch.setattr(weights, "_set", spy)
    for rank in range(2):
        mesh = Mesh(MeshConfig(tensor=2), rank, torch.device("cpu"))
        written.clear()
        bundle = ModelBundle.from_checkpoint_dir(cfg, ckpt, "cpu", mesh=mesh)
        part = bundle.dit
        kept = {id(x) for m in (part, bundle.vae, bundle.text)
                for x in (*m.parameters(), *m.buffers())}
        assert written and all(id(x) in kept for x in written)
        shared = dict(part.named_parameters())
        sliced = 0
        for name, mod in whole.named_modules():
            tp = getattr(part.get_submodule(name), "tp", None) if name else None
            for pname, p in mod.named_parameters(recurse=False):
                key = f"{name}.{pname}"
                want = p if tp is None else (tp.slice_weight(p) if pname == "weight"
                                             else tp.slice_bias(p))
                sliced += tp is not None
                assert torch.equal(shared[key], want), key
        assert sliced > 0 and part.mesh is mesh
    flags = ["--checkpoint-dir", ckpt]
    ref = run_tta.main(_argv(tmp_path / "one", *flags))["results"][0]
    ranks = _torchrun(tmp_path / "tp.json", _argv(tmp_path / "tp", "--tensor-mesh", "2",
                                                  *flags))
    for rank, rec in enumerate(ranks):
        assert rec["summary"]["config"]["checkpoint_dir"] == ckpt
        _same_video(rec["summary"]["results"][0], ref, scored=rank == 0)


def test_sweep_row_with_a_mesh(tmp_path):
    """A YAML row with context_mesh 2 runs as torchrun's 2 processes; rank 0
    writes the row's summary.json and config.json."""
    import yaml

    from longcat_video_tta_tpu_torch.sweep import run_sweep as tsw

    cfg = {"method": "delta_a", "series": "mesh", "fixed": {
        "preset": "longcat_tiny", "synthetic": 1, "height": 16, "width": 32,
        "num_cond_frames": 5, "num_frames": 5, "gen_start_frame": 16,
        "tta_total_frames": 13, "steps": 2, "es_check_every": 2, "num_inference_steps": 1,
        "caption_guard_mode": "off"},
        "sweep": [{"run_id": "cp2", "context_mesh": 2}]}
    path = tmp_path / "mesh.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert tsw.launch_command(["--x"], 2)[1:6] == ["-m", "torch.distributed.run",
                                                  "--standalone", "--nproc-per-node", "2"]
    rows = tsw.run_sweep(str(path), str(tmp_path / "res"), device="cpu")
    assert rows[0]["status"] == "ok", rows[0]
    out = tmp_path / "res" / "mesh" / "cp2"
    with open(out / "config.json") as f:
        assert json.load(f)["mesh"]["mesh"]["context"] == 2
    with open(out / "summary.json") as f:
        assert json.load(f)["num_success"] == 1


def test_jobs_give_a_mesh_row_its_devices(tmp_path, monkeypatch):
    """Under --jobs a row of N ranks takes N entries of the device pool
    (CUDA_VISIBLE_DEVICES "a,b") and launches through torchrun."""
    import threading

    import yaml

    from longcat_video_tta_tpu_torch.sweep import run_sweep as tsw

    cfg = {"method": "delta_a", "series": "jobs",
           "fixed": {"preset": "longcat_tiny", "synthetic": 1},
           "sweep": [{"run_id": "one"}, {"run_id": "cp2", "context_mesh": 2},
                     {"run_id": "tp2", "tensor_mesh": 2}]}
    path = tmp_path / "jobs.yaml"
    path.write_text(yaml.safe_dump(cfg))
    seen, lock = {}, threading.Lock()

    class _R:
        returncode = 0

    def fake_run(cmd, env=None):
        run_id = cmd[cmd.index("--output-dir") + 1].rsplit("/", 1)[-1]
        with lock:
            seen[run_id] = ((env or {}).get("CUDA_VISIBLE_DEVICES"),
                            "torch.distributed.run" in cmd)
        return _R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    rows = tsw.run_sweep(str(path), str(tmp_path / "res"), jobs=2,
                         device_pool=["0", "1", "2"], device="cpu")
    assert all(r["status"] == "ok" for r in rows)
    assert len(seen["one"][0].split(",")) == 1 and not seen["one"][1]
    for run_id in ("cp2", "tp2"):
        devs, torchrun = seen[run_id]
        assert len(set(devs.split(","))) == 2 and torchrun


def test_stop_file_drains_every_rank(tmp_path):
    """Rank 0 reads --stop-file and broadcasts it: every rank stops before
    the first video, rank 0 writes DRAINED and the checkpoint."""
    stop = tmp_path / "STOP"
    stop.write_text("")
    recs = _torchrun(tmp_path / "drain.json", _argv(tmp_path / "out", "--context-mesh", "2",
                                                     "--stop-file", str(stop)))
    for rec in recs:
        assert rec["summary"] == {"drained": True, "next_idx": 0, "num_videos": 0}
    assert recs[1]["writes"] == [] and "save_checkpoint" in recs[0]["writes"]
    assert (tmp_path / "out" / "DRAINED").exists()
