"""Each fault a cell can have, planted in the program under the whole
run (the card's look skipped, tiny size, CPU), must make ``correct``
false under the cell's own limits; so must the control (the plain
reference in float8 put in the program's place). A sound run passes.
The exchange between chips is not a fault these one-chip cells can have."""

import time

import pytest
import torch

from benchmark import core
from benchmark.backbones import cogvideox as cv_backbone
from benchmark.backbones import longcat as lc_backbone
from longcat_video_tta_tpu_torch.models import scheduler
from longcat_video_tta_tpu_torch.models.dit import LongCatDiT
from longcat_video_tta_tpu_torch.tta import engine, losses

from .tiny import COGVIDEOX, LONGCAT, PEAKS, cell

TTA = {"longcat_video_13b.tta_delta_a": LONGCAT, "cogvideox_5b_i2v.tta_delta_a": COGVIDEOX}
GEN = "longcat_video_13b.gen_dense50"


@pytest.fixture(autouse=True)
def wider_draws(monkeypatch):
    """Tiny widths with the 0.02 draws leave the text and the adapter
    almost without effect; draw the matrices 5x wider so that a fault
    moves the outputs as it does at the published widths."""
    for mod in (lc_backbone, cv_backbone):
        rule = mod.init_rule
        monkeypatch.setattr(mod, "init_rule", lambda name, rule=rule: (
            ("normal", 0.1) if rule(name)[0] == "normal" else rule(name)))


def _run(name, cfg):
    return core.run_cell(cell(name, cfg), 2 ** 32 + 11, 0.3, False, "cpu", time.perf_counter(),
                         PEAKS)


def _plant(monkeypatch, fault):
    if fault == "state_unchanged":
        update = engine.Optimizer.update

        def stuck(self, grads, state, params, **kw):
            return params, update(self, grads, state, params, **kw)[1]

        monkeypatch.setattr(engine.Optimizer, "update", stuck)
    elif fault == "half_batch":
        monkeypatch.setattr(losses, "lane_means",
                            lambda err, lanes: err.flatten()[: err.numel() // 2].mean())
    elif fault == "answer_altered":
        means = losses.lane_means
        monkeypatch.setattr(losses, "lane_means", lambda err, lanes: means(err, lanes) * 1.05)


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", sorted(TTA))
def test_tta_faults_fail_the_check(monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    out = _run(name, TTA[name])
    assert out["correct"] is (fault is None), out["checks"]


def _plant_gen(monkeypatch, fault):
    euler = scheduler.euler_step
    if fault == "state_unchanged":
        monkeypatch.setattr(scheduler, "euler_step", lambda x, v, s, s1: x)
    elif fault == "half_batch":
        fwd = LongCatDiT.forward_with_cache

        def cond_rows_only(self, x, *a, **kw):  # the negative rows left out
            out = fwd(self, x, *a, **kw)
            b = out.shape[0] // 2
            return torch.cat([out[b:], out[b:]]) if b else out

        monkeypatch.setattr(LongCatDiT, "forward_with_cache", cond_rows_only)
    elif fault == "answer_altered":
        def altered(x, v, s, s1):
            out = euler(x, v, s, s1).clone()
            out[:, :, 0] = 0.0
            return out

        monkeypatch.setattr(scheduler, "euler_step", altered)


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
def test_gen_faults_fail_the_check(monkeypatch, fault):
    _plant_gen(monkeypatch, fault)
    out = _run(GEN, LONGCAT)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("name", sorted(TTA) + [GEN])
def test_control_fails_the_check(name):
    """The reference in float8 in the program's place reads above a limit."""
    c = cell(name, LONGCAT if "longcat" in name else COGVIDEOX)
    backbone = core.module_for("backbones", c.backbone)
    drv = core.module_for("drivers", c.traffic["driver"]).Driver(
        c, backbone.build(c.config, 2 ** 31 + 3, "cpu"), 2 ** 31 + 3, "cpu")
    drv.setup()
    if c.traffic["driver"] == "gen":
        from benchmark.trace import Spans

        drv.window(time.perf_counter() + 0.2, Spans(False, "cpu"))
    checks = drv.check(lowp=True)
    assert any(x["value"] > x["limit"] for x in checks.values()), checks
