"""The port's sweep post-processing against the JAX package's, over a
copy of campaign/demo/campaign_demo (5 runs): export_results (the
all_results.json CLI, the console report, the method comparison),
export_loss_curves and run_eval's best_configs give the same bytes."""

import contextlib
import io
import os
import shutil

import pytest

from longcat_video_tta_tpu.sweep import export_loss_curves as jcurves
from longcat_video_tta_tpu.sweep import export_results as jexport
from longcat_video_tta_tpu.sweep import run_eval as jeval
from longcat_video_tta_tpu_torch.sweep import export_loss_curves as tcurves
from longcat_video_tta_tpu_torch.sweep import export_results as texport
from longcat_video_tta_tpu_torch.sweep import run_eval as teval

DEMO = os.path.join("campaign", "demo", "campaign_demo")


@pytest.fixture
def roots(tmp_path):
    root = tmp_path / "results"
    shutil.copytree(DEMO, root / "campaign_demo")
    assert len(os.listdir(root / "campaign_demo")) == 5
    return str(root), tmp_path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ret = fn(*a, **kw)
    return ret, out.getvalue()


def test_all_results_json_identical(roots):
    root, tmp = roots
    _, jout = _quiet(jexport.main, ["--results-roots", root, "--output", str(tmp / "j.json")])
    _, tout = _quiet(texport.main, ["--results-roots", root, "--output", str(tmp / "t.json")])
    assert _read(tmp / "t.json") == _read(tmp / "j.json")
    assert tout.replace("t.json", "j.json") == jout


def test_collect_match_and_report_identical(roots):
    root, _ = roots
    j = jexport.collect_all_runs([root])
    t = texport.collect_all_runs([root])
    jexport.match_baselines(j)
    texport.match_baselines(t)
    assert t == j and any(r.get("baseline_matched") for r in t)
    assert _quiet(texport.print_report, t) == _quiet(jexport.print_report, j)


def test_compare_method_dirs_identical(roots):
    root, tmp = roots
    dirs = [(name, os.path.join(root, "campaign_demo", name))
            for name in sorted(os.listdir(os.path.join(root, "campaign_demo")))]
    dirs.append(("missing", str(tmp / "nope")))
    jret, jout = _quiet(jexport.compare_method_dirs, dirs, str(tmp / "jc"))
    tret, tout = _quiet(texport.compare_method_dirs, dirs, str(tmp / "tc"))
    assert tret == jret and tout == jout
    assert _read(tmp / "tc" / "method_comparison.json") == \
        _read(tmp / "jc" / "method_comparison.json")


def test_loss_curves_identical(roots):
    root, tmp = roots
    _quiet(jcurves.main, ["--results-roots", root, "--output", str(tmp / "j.json")])
    _quiet(tcurves.main, ["--results-roots", root, "--output", str(tmp / "t.json")])
    assert _read(tmp / "t.json") == _read(tmp / "j.json")
    assert b'"curves": []' not in _read(tmp / "t.json")


@pytest.mark.parametrize("metric", ["psnr", "lpips"])
def test_best_configs_identical(roots, metric):
    root, tmp = roots
    for mod, name in ((jeval, "j.json"), (teval, "t.json")):
        _quiet(mod.main, ["--mode", "best_configs", "--results-roots", root,
                          "--metric", metric, "--output", str(tmp / name)])
    assert _read(tmp / "t.json") == _read(tmp / "j.json")
