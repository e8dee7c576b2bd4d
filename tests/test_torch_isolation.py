"""The PyTorch port stands alone: no module of it (and not chip_smoke.py)
imports ``jax`` or the JAX package, its entry points default to the
card, and asking for the card where there is none raises."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import longcat_video_tta_tpu_torch as port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "longcat_video_tta_tpu")


def _port_modules():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden_imports(path):
    return [n for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN]


def test_no_port_module_imports_jax_or_the_jax_package():
    files = list(_port_modules())
    assert len(files) > 15
    offenders = {f: b for f in files if (b := _forbidden_imports(f))}
    assert not offenders


def test_no_port_module_imports_the_repository_scripts():
    """The science loop's modules (the port's scripts/ subpackage) keep
    their own copies of what the repository's scripts/ drivers hold: no
    port module imports one of them, or ``scripts``."""
    scripts = {f[:-3] for f in os.listdir(os.path.join(REPO, "scripts")) if f.endswith(".py")}
    ours = [f for f in _port_modules() if os.sep + "scripts" + os.sep in f]
    assert {os.path.basename(f)[:-3] for f in ours} >= {
        "pretrain_demo", "make_synth_towers", "run_campaign", "run_demo_campaign",
        "probe_tta_grid", "prepare_t2v_prompts"}
    offenders = {f: bad for f in _port_modules()
                 if (bad := [n for n in _imported_names(f)
                             if n.split(".")[0] in scripts | {"scripts"}])}
    assert not offenders


def test_chip_smoke_imports_neither():
    assert not _forbidden_imports(os.path.join(REPO, "chip_smoke.py"))


def test_importing_every_port_module_loads_no_jax():
    mods = []
    for path in _port_modules():
        rel = os.path.relpath(path, os.path.dirname(PKG))[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Run from a directory holding chip_smoke.py and nothing else of the
    repo (and, here, with no GPU): non-zero exit, no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_runner_defaults_to_the_card_and_raises_without_one(tmp_path):
    from longcat_video_tta_tpu_torch.runners import run_tta

    assert run_tta.build_arg_parser().parse_args(
        ["--output-dir", str(tmp_path)]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_tta.main(["--method", "none", "--preset", "longcat_tiny",
                      "--synthetic", "1", "--output-dir", str(tmp_path)])


def test_bundle_defaults_to_the_card_and_raises_without_one():
    from longcat_video_tta_tpu_torch.config import longcat_tiny
    from longcat_video_tta_tpu_torch.pipeline.pipeline import ModelBundle

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ModelBundle.init_random(longcat_tiny(), seed=0)


def test_kernel_source_ships_and_build_dir_is_ignored():
    from longcat_video_tta_tpu_torch.ops import flash_attention as fa

    with open(fa._SOURCE) as f:
        src = f.read()
    assert "longcat_video_tta_tpu/ops/flash_attention.py::_fwd_kernel" in src
    assert 'extern "C" int lc_flash_fwd' in src
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.relpath(fa.BUILD_DIR, REPO) + "/" in ignored
