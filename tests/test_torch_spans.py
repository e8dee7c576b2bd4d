"""The port's program spans (``longcat_video_tta_tpu_torch/utils/spans.py``)
on the CPU: off without a profiler, recorded under one (names in the
kineto trace, nesting, self time, counts), consistent through an
exception, unchanged gradients under every remat policy, every name the
benchmark's program-span readers read opened by a TTA step and a
sampler run, and those readers' None without device seconds."""

import dataclasses
import sys
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import core
from longcat_video_tta_tpu_torch.config import (AdapterConfig, OptimConfig, SchedulerConfig,
                                                longcat_tiny)
from longcat_video_tta_tpu_torch.models.weights import init_random_dit
from longcat_video_tta_tpu_torch.pipeline.sampler import sample_latents
from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_chunk
from longcat_video_tta_tpu_torch.utils import spans

torch.set_num_threads(1)
READERS = ("norm_share.gen", "norm_share.tta", "rope_share.gen", "rope_share.tta",
           "block_self_share.gen", "block_self_share.tta")
READ_NAMES = {"op.layer_norm", "op.rms_norm", "op.modulate", "op.rope", "dit.block"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.fixture(scope="module")
def tiny():
    cfg = longcat_tiny().dit
    dit = init_random_dit(cfg, "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    f = lambda *s: torch.randn(s, generator=g)
    mask = torch.ones((1, cfg.text_len), dtype=torch.int32)
    mask[:, 10:] = 0
    return dict(dit=dit, cond=f(1, 16, 2, 4, 6), train=f(1, 16, 2, 4, 6),
                val=f(1, 16, 1, 4, 6), fixed=f(2, 1, 16, 1, 4, 6),
                text=f(1, cfg.text_len, cfg.text_dim), mask=mask,
                draws=[(torch.tensor([0.4]), f(1, 16, 2, 4, 6))])


def test_off_returns_the_null_context_and_records_nothing(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was created with the profiler off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with _cpu_profile():
        with spans.span("t.outer"):
            pass
    before = spans.totals()
    for _ in range(3):
        s = spans.span("t.off")
        assert s is spans._NULL
        with s:
            pass
    assert spans.totals() == before
    assert "t.off" not in before["spans"]


def test_on_records_names_nesting_self_time_and_counts():
    with _cpu_profile() as prof:
        with spans.span("t.outer"):
            time.sleep(0.02)
            for _ in range(2):
                with spans.span("t.inner"):
                    time.sleep(0.01)
                    with spans.span("t.leaf"):
                        pass
    t = spans.totals()["spans"]
    assert {"t.outer", "t.inner", "t.leaf"} <= _names(prof)
    assert (t["t.outer"]["n"], t["t.inner"]["n"], t["t.leaf"]["n"]) == (1, 2, 2)
    outer, inner, leaf = t["t.outer"], t["t.inner"], t["t.leaf"]
    assert outer["host_s"] >= 0.04 and inner["host_s"] >= 0.02
    assert outer["host_self_s"] == pytest.approx(outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["host_self_s"] == pytest.approx(inner["host_s"] - leaf["host_s"], abs=1e-9)
    assert leaf["host_self_s"] == leaf["host_s"]
    assert 0.02 <= outer["host_self_s"] < outer["host_s"] - 0.02
    assert all(v["device_s"] == 0.0 and v["self_s"] == 0.0 for v in t.values())
    # a new recording clears the last one; its counters start from zero
    with _cpu_profile():
        with spans.span("t.again"):
            pass
    again = spans.totals()
    assert set(again["spans"]) == {"t.again"}
    assert set(again["counters"]) >= {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                      "bsa_block_sum", "bsa_fwd", "bsa_fwd_qk_int8"}
    assert all(v == 0 for v in again["counters"].values())


def test_an_exception_leaves_the_recorder_consistent():
    with _cpu_profile():
        with spans.span("t.outer"):
            with pytest.raises(ValueError):
                with spans.span("t.raises"):
                    raise ValueError("inside a span")
            assert spans._rec.stack()[-1].name == "t.outer"
            with spans.span("t.after"):
                pass
        assert spans._rec.stack() == []
    t = spans.totals()["spans"]
    assert t["t.raises"]["n"] == t["t.after"]["n"] == t["t.outer"]["n"] == 1
    assert t["t.outer"]["host_self_s"] == pytest.approx(
        t["t.outer"]["host_s"] - t["t.raises"]["host_s"] - t["t.after"]["host_s"], abs=1e-9)


def test_a_span_on_another_thread_nests_under_the_recording_threads_span():
    """As the autograd engine's device thread re-running a checkpointed
    block in the backward: its stack is empty, so its parent is the span
    open on the recording's thread."""
    with _cpu_profile():
        with spans.span("t.backward"):
            def work():  # this thread's profiler state is off: enter a span directly
                s = spans._Span()
                s.name = "t.recompute"
                with s:
                    time.sleep(0.01)

            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    t = spans.totals()["spans"]
    assert t["t.recompute"]["n"] == 1
    assert t["t.backward"]["host_self_s"] == pytest.approx(
        t["t.backward"]["host_s"] - t["t.recompute"]["host_s"], abs=1e-9)


def test_closed_spans_are_resolved_and_reused_as_they_go():
    ids = set()
    with _cpu_profile():
        for _ in range(3 * spans._RESOLVE_EVERY):
            with spans.span("t.many") as s:
                ids.add(id(s))
        assert len(spans._rec.pending) < spans._RESOLVE_EVERY
    assert spans.totals()["spans"]["t.many"]["n"] == 3 * spans._RESOLVE_EVERY
    assert len(ids) <= spans._RESOLVE_EVERY + 1


def _delta_a_grad(tiny, policy):
    from longcat_video_tta_tpu_torch.tta.losses import flow_matching_loss_conditioned

    dit = tiny["dit"]
    cfg = dataclasses.replace(dit.cfg, remat=True, remat_policy=policy)
    d = torch.full((cfg.adaln_tembed_dim,), 0.1, requires_grad=True)
    old = dit.cfg
    dit.cfg = cfg
    try:
        sigma, noise = tiny["draws"][0]
        loss = flow_matching_loss_conditioned(dit, tiny["cond"], tiny["train"], tiny["text"],
                                              tiny["mask"], adapters={"delta_t": d},
                                              sigma=sigma, noise=noise)
        (g,) = torch.autograd.grad(loss, [d])
    finally:
        dit.cfg = old
    return loss.detach(), g


@pytest.mark.parametrize("policy", ["full", "dots", "dots_attn"])
def test_remat_under_a_recording_profiler_keeps_gradients_and_counts_the_recompute(
        tiny, policy):
    loss0, g0 = _delta_a_grad(tiny, policy)
    with _cpu_profile():
        loss1, g1 = _delta_a_grad(tiny, policy)
    t = spans.totals()["spans"]
    assert torch.equal(loss0, loss1) and torch.equal(g0, g1)
    depth = tiny["dit"].cfg.depth
    assert t["dit.block"]["n"] == 2 * depth  # the forward and the backward's recompute
    assert t["op.attention"]["n"] == 2 * 2 * depth  # self and cross, twice


def test_a_tta_step_and_a_sampler_run_open_every_name_the_readers_read(tiny):
    dit = tiny["dit"]
    scheme = build_scheme(dit.cfg, AdapterConfig(method="delta_a"))
    opt = build_optimizer(OptimConfig(lr=5e-3, steps=2))
    tp = scheme.init("cpu", dit=dit)
    with _cpu_profile() as prof:
        train_chunk(scheme, dit, opt, tp, opt.init(tp), tiny["cond"], tiny["train"],
                    tiny["text"], tiny["mask"], steps=1, draws=tiny["draws"],
                    val_latents=tiny["val"], fixed_noises=tiny["fixed"],
                    anchor_sigmas=(0.5, 0.8))
    t = spans.totals()["spans"]
    assert READ_NAMES | {"tta.step", "tta.forward", "tta.backward", "tta.optimizer",
                         "tta.anchor", "op.linear", "op.attention"} <= set(t)
    assert READ_NAMES <= _names(prof)
    assert t["tta.step"]["n"] == t["tta.anchor"]["n"] == 1
    assert t["tta.step"]["host_s"] >= (t["tta.forward"]["host_s"] + t["tta.backward"]["host_s"]
                                       + t["tta.optimizer"]["host_s"])
    with _cpu_profile():
        with torch.no_grad():
            sample_latents(dit, SchedulerConfig(), tiny["text"], tiny["mask"], tiny["text"],
                           tiny["mask"], 4.0, num_gen_latents=1, num_steps=2, lat_h=4,
                           lat_w=6, cond_latents=tiny["cond"],
                           generator=torch.Generator().manual_seed(2))
    t = spans.totals()["spans"]
    assert READ_NAMES | {"sampler.cond_cache", "sampler.step"} <= set(t)
    assert (t["sampler.cond_cache"]["n"], t["sampler.step"]["n"]) == (1, 2)
    assert t["dit.block"]["n"] == 3 * dit.cfg.depth  # the cache and two steps


def test_program_span_readers_give_none_without_device_seconds(monkeypatch):
    run = types.SimpleNamespace(span_window_s=1.0)
    with _cpu_profile():
        with spans.span("dit.block"):
            with spans.span("op.rope"):
                pass
    assert spans.totals()["spans"]["op.rope"]["device_s"] == 0.0
    for name in READERS:
        assert core.reader(name).read(run) is None
    monkeypatch.setitem(sys.modules, "longcat_video_tta_tpu_torch.utils.spans", None)
    for name in READERS:  # a program without the spans module
        assert core.reader(name).read(run) is None


def test_program_span_readers_read_device_seconds(monkeypatch):
    fake = {"spans": {"op.layer_norm": dict(device_s=0.2, self_s=0.2),
                      "op.modulate": dict(device_s=0.1, self_s=0.1),
                      "op.rope": dict(device_s=0.05, self_s=0.05),
                      "dit.block": dict(device_s=0.9, self_s=0.3)},
            "counters": {}}
    monkeypatch.setattr(spans, "totals", lambda: fake)
    run = types.SimpleNamespace(span_window_s=2.0)
    got = {name: core.reader(name).read(run) for name in READERS}
    for sfx in ("gen", "tta"):
        assert got[f"norm_share.{sfx}"] == pytest.approx(15.0)
        assert got[f"rope_share.{sfx}"] == pytest.approx(2.5)
        assert got[f"block_self_share.{sfx}"] == pytest.approx(15.0)
