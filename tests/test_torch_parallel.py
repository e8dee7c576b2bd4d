"""The port's multi-rank paths (longcat_video_tta_tpu_torch/parallel/)
against the JAX package's, case for case with tests/test_parallel.py and
tests/test_parallel_misc.py.

Each case runs the JAX function here, on the 8 virtual CPU devices of
tests/conftest.py. The port runs in fresh rank processes over gloo
(tests/torch_parallel_worker.py: torch and the port only), three worlds
started once for the module: 8 ranks as data 2 x context 2 x tensor 2,
4 context ranks, 2 data ranks. Inputs made with numpy from a seed and
JAX's weights and draws reach the ranks through an .npz file.

Tolerances: fp32 ring and cp attention against the unsharded attention
within 1e-5 relative (atol 1e-6); the sharded DiT forward, the samplers
and the train steps within the reference's own atol 2e-4 / rtol 1e-3
(test_parallel.py:81-82). The planted fault (a replicated tensor's
gradient left without its all-reduce over the context ranks) must move
the trained delta away from the single-rank one.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longcat_video_tta_tpu.config import (
    AdapterConfig, CFGReuseConfig, MeshConfig, OptimConfig, PABConfig, longcat_tiny,
)
from longcat_video_tta_tpu.models import dit as M
from longcat_video_tta_tpu.parallel import (
    build_mesh, param_specs as jax_param_specs, shard_batch, shard_params,
)
from longcat_video_tta_tpu.pipeline import sample_latents
from longcat_video_tta_tpu.pipeline.sampler import sample_latents_segmented
from longcat_video_tta_tpu.tta import build_optimizer, build_scheme, make_train_step

CFG = dataclasses.replace(longcat_tiny().dit, hidden_size=64, num_heads=2, ffn_dim=128)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
DIT_TOL = dict(atol=2e-4, rtol=1e-3)
WORLDS = {  # name: (mesh (data, context, tensor), tasks)
    "dct": ((2, 2, 2), ["mesh", "forward", "full_step", "sample_plain"]),
    "cp": ((1, 4, 1), ["stripes", "attention", "forward", "sample", "delta_step"]),
    "dp": ((2, 1, 1), ["vp_chunk", "dcn_chunk"]),
}


def _draws(key, shape):
    """The sigma and noise JAX's conditioned loss draws from ``key``."""
    k_sig, k_noise = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_sig, (shape[0],), minval=0.001, maxval=1.0)),
            np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)
    return out


def _vp_inputs(rng, V, method_cfg, params, seeds, steps):
    """Per-lane data, inits and JAX draws of a batched chunk (V lanes)."""
    from longcat_video_tta_tpu.tta import split_tta_latents

    d = {}
    conds, trains = [], []
    for v in range(V):
        lat = rng.standard_normal((1, CFG.in_channels, 4, 8, 16)).astype(np.float32)
        lat = lat * (0.8 + 0.2 * v)
        c, tr, _ = split_tta_latents(jnp.asarray(lat), 2, 0.25)
        conds.append(np.asarray(c))
        trains.append(np.asarray(tr))
    d["cond"], d["train"] = np.stack(conds), np.stack(trains)
    d["emb"] = np.stack([rng.standard_normal((1, CFG.text_len, CFG.text_dim))
                         .astype(np.float32)] * V)
    d["mask"] = np.ones((V, 1, CFG.text_len), np.int32)
    scheme = build_scheme(CFG, method_cfg)
    inits = [scheme.init(jax.random.PRNGKey(seeds + v), base_params=params)
             for v in range(V)]
    tps = jax.tree.map(lambda *x: jnp.stack(x), *inits)
    d.update({f"tp/{k}": np.asarray(x) for k, x in tps.items()})
    keys = [[jax.random.PRNGKey(v * 100 + s) for s in range(steps)] for v in range(V)]
    sig, noi = zip(*[zip(*[_draws(k, d["train"].shape[1:]) for k in row]) for row in keys])
    d["sigma"], d["noise"] = np.array(sig), np.array(noi)
    return d, tps, keys


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The inputs, JAX's weights and draws, and every world's rank
    outputs ({world: {task: [rank arrays]}})."""
    rng = np.random.default_rng(0)
    params = M.init_dit(jax.random.PRNGKey(0), CFG, zero_init=False)
    B, C = 2, CFG.in_channels
    arr = {
        "lat": rng.standard_normal((B, C, 4, 8, 16)).astype(np.float32),
        "text": rng.standard_normal((B, CFG.text_len, CFG.text_dim)).astype(np.float32),
        "mask": np.ones((B, CFG.text_len), np.int32),
        "init_noise": rng.standard_normal((1, C, 2, 8, 16)).astype(np.float32),
    }
    arr["lat_p"] = np.concatenate([arr["lat"], np.full((B, C, 4, 8, 16), 13.5, np.float32)], 2)
    arr["noise_p"] = np.concatenate([arr["lat"][:, :, :3],
                                     np.full((B, C, 1, 8, 16), 9.5, np.float32)], 2)
    for name, (S, Sk, H, D) in {"attn": (64, 64, 2, 16), "grad": (32, 32, 2, 8),
                                "dec": (32, 48, 2, 16), "kv": (64, 64, 2, 16)}.items():
        arr[f"{name}_q"] = rng.standard_normal((1, S, H, D)).astype(np.float32)
        arr[f"{name}_k"] = rng.standard_normal((1, Sk, H, D)).astype(np.float32)
        arr[f"{name}_v"] = rng.standard_normal((1, Sk, H, D)).astype(np.float32)
    arr["stripe_x"] = rng.standard_normal((4, 300_001)).astype(np.float32)
    arr["grad_w"] = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    arr["kv_w"] = rng.standard_normal((1, 44, 2, 16)).astype(np.float32)
    arr["sigma"], arr["noise"] = _draws(jax.random.PRNGKey(4), (B, C, 2, 8, 16))
    vp, vp_tps, vp_keys = _vp_inputs(rng, 2, AdapterConfig(method="delta_b", num_groups=2),
                                     params, 7, 3)
    dcn, dcn_tps, dcn_keys = _vp_inputs(rng, 4, AdapterConfig(method="delta_a"), params,
                                        5, 2)
    arr.update({f"vp_{k}": x for k, x in vp.items()})
    arr.update({f"dcn_{k}": x for k, x in dcn.items()})
    arr.update(_flat(params, "params"))
    outs = {}
    for world, (mesh, tasks) in WORLDS.items():
        folder = tmp_path_factory.mktemp(world)
        np.savez(folder / "in.npz", **arr)
        with open(folder / "tasks.json", "w") as f:
            json.dump({"mesh": mesh, "tasks": tasks}, f)
        _spawn(str(folder), int(np.prod(mesh)))
        outs[world] = {task: [dict(np.load(folder / f"{task}.rank{r}.npz"))
                              for r in range(int(np.prod(mesh)))] for task in tasks}
    return dict(params=params, arr=arr, outs=outs, vp=(vp_tps, vp_keys),
                dcn=(dcn_tps, dcn_keys))


def _spawn(folder, world):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
    procs = [subprocess.Popen([sys.executable, WORKER, folder, str(r), str(world),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {folder} failed:\n{log}"


def _tokens(parts, key):
    """The whole token axis from the context ranks' shards."""
    return np.concatenate([p[key] for p in parts], axis=1)


def _jax_mesh(context=4, data=1, tensor=1):
    return build_mesh(MeshConfig(data=data, context=context, tensor=tensor))


# ---------------------------------------------------------------------------
# test_parallel.py, case for case
# ---------------------------------------------------------------------------


def test_mesh_axes(ctx):
    """Row-major (data, context, tensor): rank = (d * C + c) * T + t, the
    reference mesh's device order."""
    mesh = _jax_mesh(data=2, context=2, tensor=2)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, rec in enumerate(ctx["outs"]["dct"]["mesh"]):
        assert tuple(rec["coords"]) == tuple(np.argwhere(ids == r)[0])
        assert tuple(rec["sizes"]) == (2, 2, 2)
        d, c, t = rec["coords"]
        assert list(rec["members"][1]) == [(d * 2 + cc) * 2 + t for cc in range(2)]


def test_large_messages_ride_the_stripes(ctx):
    """A 1.2 MB message is cut over the context group's stripes (gloo's
    one TCP stream per pair carries about a GB/s): the all-reduce equals
    numpy's sum and max and the group's own all-reduce, on every rank
    alike; one ring rotation hands rank m rank m + 1's tensor whole."""
    x = ctx["arr"]["stripe_x"]
    ranks = ctx["outs"]["cp"]["stripes"]
    for r, rec in enumerate(ranks):
        np.testing.assert_allclose(rec["sum"], x.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rec["sum"], rec["sum_whole"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(rec["sum"], ranks[0]["sum"])
        np.testing.assert_array_equal(rec["max"], x.max(0))
        np.testing.assert_array_equal(rec["shift"], 2 * x[(r + 1) % 4])


def _port_dit(params, cfg=CFG):
    from longcat_video_tta_tpu_torch.config import longcat_tiny as t_tiny
    from longcat_video_tta_tpu_torch.models.weights import load_dit_from_numpy

    tcfg = dataclasses.replace(t_tiny().dit, hidden_size=64, num_heads=2, ffn_dim=128)
    return load_dit_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _jax_spec_in_torch_layout(spec, ndim):
    """A reference spec of a stacked [L, in, out] kernel / [L, out] vector
    as the port's [out, in] / [out] spec."""
    tup = tuple(spec)[1:] if spec else ()
    tup = tup + (None,) * (ndim - len(tup))
    return tuple(reversed(tup)) if ndim == 2 and tup else tup


def test_param_specs_cover_tensor_axis(ctx):
    """Every port tensor of block 0 and the embedders takes the reference
    rule's spec."""
    from longcat_video_tta_tpu_torch.parallel.sharding import param_specs

    specs = param_specs(_port_dit(ctx["params"]))
    jspecs = jax_param_specs(ctx["params"])
    assert any("tensor" in s for s in specs.values())
    for path in ("attn/qkv/kernel", "attn/qkv/bias", "attn/proj/kernel",
                 "cross_attn/q/kernel", "cross_attn/kv/kernel", "cross_attn/proj/kernel",
                 "ffn/w1/kernel", "ffn/w2/kernel", "ffn/w3/kernel", "adaln/kernel",
                 "adaln/bias", "attn/q_norm", "pre_crs_norm/weight"):
        node = jspecs["blocks"]
        for p in path.split("/"):
            node = node[p]
        name = "blocks.0." + path.replace("/", ".").replace("kernel", "weight")
        want = _jax_spec_in_torch_layout(node, 2 if path.endswith("kernel") else 1)
        assert tuple(x for x in specs[name] if x) == tuple(x for x in want if x), name
        assert specs[name] == want or not any(want), name
    assert specs["x_embed.weight"] == () and specs["final.proj.weight"] == ()


def test_param_specs_cover_int8_quantized_tree(ctx):
    """kernel_i8 -> weight_i8 keeps its kernel's spec; the per-output scale
    that spec without its contraction axis."""
    from longcat_video_tta_tpu_torch.ops.quant import quantize_dit_blocks_int8
    from longcat_video_tta_tpu_torch.parallel.sharding import param_specs

    specs = param_specs(quantize_dit_blocks_int8(_port_dit(ctx["params"])))
    assert specs["blocks.0.attn.qkv.weight_i8"] == ("tensor", None)
    assert specs["blocks.0.attn.qkv.scale"] == ("tensor",)
    assert specs["blocks.0.attn.proj.weight_i8"] == (None, "tensor")
    assert specs["blocks.0.attn.proj.scale"] == (None,)
    with pytest.raises(ValueError, match="no 'mmdit'"):
        param_specs(_port_dit(ctx["params"]), "mmdit")


def test_sharded_forward_matches_single_device(ctx):
    """dp 2 x cp 2 x tp 2 ranks == the reference's sharded forward."""
    params, a = ctx["params"], ctx["arr"]
    mesh = _jax_mesh(data=2, context=2, tensor=2)
    with mesh:
        p = shard_params(mesh, params)
        lat, txt, msk = shard_batch(mesh, jnp.asarray(a["lat"]), jnp.asarray(a["text"]),
                                    jnp.asarray(a["mask"]))
        ref = M.dit_forward(p, CFG, lat, jnp.full((2,), 500.0), txt, msk,
                            num_cond_latents=2, attn_impl="xla")
    ranks = ctx["outs"]["dct"]["forward"]
    got = np.concatenate([ranks[d * 4]["fwd"] for d in range(2)])
    np.testing.assert_allclose(got, np.asarray(ref), **DIT_TOL)
    for r, rec in enumerate(ranks):  # every rank of a data line holds its rows whole
        np.testing.assert_array_equal(rec["fwd"], ranks[(r // 4) * 4]["fwd"])


def _jax_full_step(params, a, lr=1e-2):
    mesh = _jax_mesh(data=2, context=2, tensor=2)
    with mesh:
        p = shard_params(mesh, params)
        lat, txt, msk = shard_batch(mesh, jnp.asarray(a["lat"]), jnp.asarray(a["text"]),
                                    jnp.asarray(a["mask"]))
        scheme = build_scheme(CFG, AdapterConfig(method="full"))
        tp = scheme.init(jax.random.PRNGKey(3), base_params=p)
        tx = build_optimizer(OptimConfig(lr=lr, optimizer="sgd"))
        step = make_train_step(scheme, CFG, tx, attn_impl="xla", cp_mesh=mesh)
        tp, _, loss = step(tp, tx.init(tp), p, lat[:, :, :2], lat[:, :, 2:], txt, msk,
                           jax.random.PRNGKey(4))
    return float(loss), tp


def test_sharded_full_tta_step(ctx):
    """The full method's SGD step with every axis split (the reference's
    draws): the loss, and each tensor's update (gathered whole) against
    the reference's sharded step."""
    loss, tp = _jax_full_step(ctx["params"], ctx["arr"])
    base = _port_dit(ctx["params"]).state_dict()
    new = _port_dit(tp).state_dict()
    for rec in ctx["outs"]["dct"]["full_step"]:
        assert np.isfinite(rec["loss"])
        np.testing.assert_allclose(float(rec["loss"]), loss, rtol=1e-5)
        for key, ref in new.items():
            upd_ref = (ref - base[key]).numpy()
            upd = rec[f"p/{key}"] - base[key].numpy()
            np.testing.assert_allclose(upd, upd_ref, rtol=1e-3,
                                       atol=1e-3 * float(np.abs(upd_ref).max()) + 1e-9,
                                       err_msg=key)


def test_graft_entry_dryrun(ctx):
    """The reference's 8-device dry run (__graft_entry__.dryrun_multichip):
    a sharded full step and a sharded generation, here on 8 ranks: the
    step's loss finite on every rank, the generation equal to the
    reference's single-device sampler on the same noise."""
    a = ctx["arr"]
    ref = sample_latents(ctx["params"], CFG, longcat_tiny().scheduler,
                         jax.random.PRNGKey(0), jnp.asarray(a["text"][:1]),
                         jnp.asarray(a["mask"][:1]), jnp.asarray(a["text"][:1]),
                         jnp.asarray(a["mask"][:1]), 4.0, num_gen_latents=2, num_steps=2,
                         lat_h=8, lat_w=16, cond_latents=jnp.asarray(a["lat"][:1, :, :2]),
                         attn_impl="xla", use_kv_cache=True,
                         init_noise=jnp.asarray(a["init_noise"]))
    for r in range(8):
        assert np.isfinite(ctx["outs"]["dct"]["full_step"][r]["loss"])
        np.testing.assert_allclose(ctx["outs"]["dct"]["sample_plain"][r]["plain2"],
                                   np.asarray(ref), **DIT_TOL)


def test_cp_attention_matches_unsharded(ctx):
    from longcat_video_tta_tpu.ops.attention import attention_xla

    a = ctx["arr"]
    q, k, v = (jnp.asarray(a[f"attn_{n}"]) for n in "qkv")
    for ncond in (0, 24):  # 24 crosses the 16-token shard boundary
        ref = attention_xla(q, k, v, num_cond_tokens=ncond)
        got = _tokens(ctx["outs"]["cp"]["attention"], f"cp{ncond}")
        np.testing.assert_allclose(got, np.asarray(ref), **ATTN_TOL, err_msg=f"{ncond}")


def test_dit_forward_context_parallel_matches(ctx):
    """The DiT over 4 context ranks == the reference's cp forward."""
    params, a = ctx["params"], ctx["arr"]
    mesh = _jax_mesh()
    with mesh:
        ref = M.dit_forward(params, CFG, jnp.asarray(a["lat"]), jnp.full((2,), 500.0),
                            jnp.asarray(a["text"]), jnp.asarray(a["mask"]),
                            num_cond_latents=2, attn_impl="xla", cp_mesh=mesh)
    for rec in ctx["outs"]["cp"]["forward"]:
        np.testing.assert_allclose(rec["fwd"], np.asarray(ref), **DIT_TOL)


def test_ring_attention_matches_unsharded_and_allgather(ctx):
    from longcat_video_tta_tpu.ops.attention import attention_xla
    from longcat_video_tta_tpu.parallel.context_attention import ring_self_attention as jring

    a = ctx["arr"]
    q, k, v = (jnp.asarray(a[f"attn_{n}"]) for n in "qkv")
    mesh = _jax_mesh()
    for ncond in (0, 24):
        ref = attention_xla(q, k, v, num_cond_tokens=ncond)
        with mesh:
            jr = jring(q, k, v, mesh, num_cond_tokens=ncond, impl="xla")
        ring = _tokens(ctx["outs"]["cp"]["attention"], f"ring{ncond}")
        cp = _tokens(ctx["outs"]["cp"]["attention"], f"cp{ncond}")
        np.testing.assert_allclose(ring, np.asarray(ref), **ATTN_TOL)
        np.testing.assert_allclose(ring, np.asarray(jr), **ATTN_TOL)
        np.testing.assert_allclose(ring, cp, **ATTN_TOL)


def test_ring_attention_gradients_match_unsharded(ctx):
    from longcat_video_tta_tpu.ops.attention import attention_xla

    a = ctx["arr"]
    q, k, v, w = (jnp.asarray(a[f"grad_{n}"]) for n in ("q", "k", "v", "w"))
    g = jax.grad(lambda q, k, v: jnp.sum(attention_xla(q, k, v, num_cond_tokens=12) * w),
                 argnums=(0, 1, 2))(q, k, v)
    for ref, name in zip(g, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_tokens(ctx["outs"]["cp"]["attention"], name),
                                   np.asarray(ref), **ATTN_TOL, err_msg=name)


def test_ring_attention_decode_shapes(ctx):
    """Sq (noise) != Sk: no prefix (a ncond is dropped, as the reference
    drops it), ring and cp alike."""
    from longcat_video_tta_tpu.ops.attention import attention_xla

    a = ctx["arr"]
    q, k, v = (jnp.asarray(a[f"dec_{n}"]) for n in "qkv")
    parts = ctx["outs"]["cp"]["attention"]
    ref = np.asarray(attention_xla(q, k, v))
    np.testing.assert_allclose(_tokens(parts, "dec0"), ref, **ATTN_TOL)
    ref_c = np.asarray(attention_xla(q, k, v, num_cond_tokens=16))
    np.testing.assert_allclose(_tokens(parts, "dec16"), ref_c, **ATTN_TOL)
    np.testing.assert_allclose(_tokens(parts, "dec_cp16"), ref_c, **ATTN_TOL)


def _jax_sample(params, a, mesh=None, segment_steps=0, **kw):
    fn = sample_latents_segmented if segment_steps else sample_latents
    extra = {"segment_steps": segment_steps} if segment_steps else {}
    args = (params, CFG, longcat_tiny().scheduler, jax.random.PRNGKey(0),
            jnp.asarray(a["text"][:1]), jnp.asarray(a["mask"][:1]),
            jnp.asarray(a["text"][:1]), jnp.asarray(a["mask"][:1]), 4.0)
    common = dict(num_gen_latents=2, lat_h=8, lat_w=16, attn_impl="xla",
                  cond_latents=jnp.asarray(a["lat"][:1, :, :2]), use_kv_cache=True,
                  init_noise=jnp.asarray(a["init_noise"]), **extra, **kw)
    if mesh is None:
        return np.asarray(fn(*args, **common))
    with mesh:
        return np.asarray(fn(*args, cp_mesh=mesh, **common))


def test_sample_latents_context_parallel_matches(ctx):
    ref = _jax_sample(ctx["params"], ctx["arr"], _jax_mesh(), num_steps=2)
    for rec in ctx["outs"]["cp"]["sample"]:
        np.testing.assert_allclose(rec["plain2"], ref, **DIT_TOL)


def test_sample_latents_pab_under_context_parallel(ctx):
    """PAB every 1 under the ring == the ring without PAB; every 2 == the
    reference's every 2 under its ring; segmented == one pass."""
    pab2 = PABConfig(every=2, start_frac=0.25, end_frac=1.0)
    ref = _jax_sample(ctx["params"], ctx["arr"], _jax_mesh(), num_steps=4, pab_cfg=pab2)
    for rec in ctx["outs"]["cp"]["sample"]:
        np.testing.assert_allclose(rec["pab1"], rec["plain4"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(rec["pab2"], ref, **DIT_TOL)
        np.testing.assert_allclose(rec["pab2_seg"], rec["pab2"], atol=1e-5, rtol=1e-5)


def test_factorize_devices_prefers_context():
    from longcat_video_tta_tpu.parallel import factorize_devices as jf
    from longcat_video_tta_tpu_torch.config import MeshConfig as TMeshConfig
    from longcat_video_tta_tpu_torch.parallel import factorize_devices

    cfg = factorize_devices(8)
    assert cfg == TMeshConfig(data=1, context=8, tensor=1)
    assert (cfg.data, cfg.context, cfg.tensor) == (jf(8).data, jf(8).context, jf(8).tensor)


def _jax_lane_chunk(params, acfg, tps, keys, a, pre, steps):
    from longcat_video_tta_tpu.tta.engine import make_batched_train_chunk

    scheme = build_scheme(CFG, acfg)
    tx = build_optimizer(OptimConfig(lr=1e-2, optimizer="adamw"))
    V = a[f"{pre}_cond"].shape[0]
    osts = jax.tree.map(lambda *x: jnp.stack(x),
                        *[tx.init(jax.tree.map(lambda t: t[v], tps)) for v in range(V)])
    rngs = jnp.stack([jnp.stack(row) for row in keys])
    chunk = make_batched_train_chunk(scheme, CFG, tx,
                                     mesh=build_mesh(MeshConfig(data=2, context=1,
                                                                tensor=1)))
    tps_o, _, losses, _ = chunk(tps, osts, params, *(jnp.asarray(a[f"{pre}_{k}"]) for k in
                                                     ("cond", "train", "emb", "mask")), rngs)
    return np.asarray(losses), jax.tree.map(np.asarray, tps_o)


def _check_lanes(ranks, losses, tps_o):
    seen = []
    for rec in ranks:
        for j, v in enumerate(rec["lanes"]):
            seen.append(int(v))
            np.testing.assert_allclose(rec["losses"][j], losses[v], rtol=2e-5, atol=1e-6)
            for key, val in tps_o.items():
                np.testing.assert_allclose(rec[f"tp/{key}"][j], val[v], rtol=2e-5,
                                           atol=1e-6, err_msg=key)
    assert sorted(seen) == list(range(len(losses)))


def test_video_parallel_chunk_matches_sequential(ctx):
    """The lanes of a --video-parallel group split over 2 data ranks: each
    lane equal to the reference's batched chunk sharded over its data
    mesh (which equals each video's own sequential run there)."""
    tps, keys = ctx["vp"]
    losses, tps_o = _jax_lane_chunk(ctx["params"], AdapterConfig(method="delta_b",
                                                                 num_groups=2),
                                    tps, keys, ctx["arr"], "vp", 3)
    _check_lanes(ctx["outs"]["dp"]["vp_chunk"], losses, tps_o)


def test_ring_attention_kv_valid_bucketing(ctx):
    """A global key bound across ring chunks: valid outputs and gradients
    equal the unsharded attention on the unpadded slice; pad keys get no
    gradient."""
    from longcat_video_tta_tpu.ops.attention import attention_xla

    a = ctx["arr"]
    valid = 44
    q, k, v = (jnp.asarray(a[f"kv_{n}"]) for n in "qkv")
    w = jnp.asarray(a["kv_w"])
    ref = attention_xla(q[:, :valid], k[:, :valid], v[:, :valid], num_cond_tokens=16)
    parts = ctx["outs"]["cp"]["attention"]
    np.testing.assert_allclose(_tokens(parts, "kv_o")[:, :valid], np.asarray(ref),
                               **ATTN_TOL)
    g = jax.grad(lambda q, k, v: jnp.sum(attention_xla(
        q[:, :valid], k[:, :valid], v[:, :valid], num_cond_tokens=16) * w),
        argnums=(0, 1, 2))(q, k, v)
    for ref_g, name in zip(g, ("kv_dq", "kv_dk", "kv_dv")):
        got = _tokens(parts, name)
        np.testing.assert_allclose(got[:, :valid], np.asarray(ref_g)[:, :valid],
                                   **ATTN_TOL, err_msg=name)
        if name != "kv_dq":
            np.testing.assert_allclose(got[:, valid:], 0.0, atol=1e-7, err_msg=name)


def test_dit_forward_bucketed_context_parallel_matches(ctx):
    params, a = ctx["params"], ctx["arr"]
    mesh = _jax_mesh()
    ts = jnp.concatenate([jnp.zeros((2, 2)), jnp.full((2, 6), 500.0)], axis=1)
    with mesh:
        ref = M.dit_forward(params, CFG, jnp.asarray(a["lat_p"]), ts,
                            jnp.asarray(a["text"]), jnp.asarray(a["mask"]),
                            num_cond_latents=2, attn_impl="xla", cp_mesh=mesh,
                            num_valid_latents=jnp.int32(4))
    for rec in ctx["outs"]["cp"]["forward"]:
        np.testing.assert_allclose(rec["bucket"][:, :, :4], np.asarray(ref)[:, :, :4],
                                   **DIT_TOL)


def test_bucketed_cached_decode_under_cp(ctx):
    """The port's decode keeps the cache and the fresh tokens as two
    pieces of each ring chunk, so the global key bound falls on the right
    keys; the reference shards [cache ++ fresh] contiguously."""
    params, a = ctx["params"], ctx["arr"]
    mesh = _jax_mesh()
    text, mask = jnp.asarray(a["text"]), jnp.asarray(a["mask"])
    with mesh:
        cache = M.dit_precompute_cond_cache(params, CFG, jnp.asarray(a["lat"][:, :, :2]),
                                            text, mask, attn_impl="xla", cp_mesh=mesh)
        ref = M.dit_forward_with_cache(params, CFG, jnp.asarray(a["noise_p"]),
                                       jnp.full((2,), 500.0), text, mask, cache,
                                       num_cond_latents=2, attn_impl="xla", cp_mesh=mesh,
                                       num_valid_latents=jnp.int32(3))
    for rec in ctx["outs"]["cp"]["forward"]:
        np.testing.assert_allclose(rec["cache_bucket"][:, :, :3], np.asarray(ref)[:, :, :3],
                                   **DIT_TOL)


def test_sample_latents_cfg_reuse_under_context_parallel(ctx):
    r2 = CFGReuseConfig(every=2, start_frac=0.25, end_frac=1.0)
    ref = _jax_sample(ctx["params"], ctx["arr"], _jax_mesh(), num_steps=4, cfgr_cfg=r2)
    for rec in ctx["outs"]["cp"]["sample"]:
        np.testing.assert_allclose(rec["cfgr1"], rec["plain4"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(rec["cfgr2"], ref, **DIT_TOL)
        np.testing.assert_allclose(rec["cfgr2_seg"], rec["cfgr2"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# test_parallel_misc.py, case for case
# ---------------------------------------------------------------------------


def test_init_distributed_noop_without_coordinator(monkeypatch):
    from longcat_video_tta_tpu_torch.parallel import init_distributed

    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False


def test_two_process_dcn_sharded_step(ctx):
    """Two rank processes, each with 2 of 4 delta_a lanes: every lane
    finite and equal to the reference's batched chunk over its data
    mesh."""
    tps, keys = ctx["dcn"]
    losses, tps_o = _jax_lane_chunk(ctx["params"], AdapterConfig(method="delta_a"),
                                    tps, keys, ctx["arr"], "dcn", 2)
    ranks = ctx["outs"]["dp"]["dcn_chunk"]
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    _check_lanes(ranks, losses, tps_o)


# ---------------------------------------------------------------------------
# the train step under context parallelism, and its planted fault
# ---------------------------------------------------------------------------


def test_context_parallel_delta_step_and_planted_fault(ctx):
    """One delta_a SGD step over 4 context ranks equals the reference's
    single-device step on the same draws; leaving out the all-reduce of
    the replicated delta's gradient (each rank keeps its tokens' share)
    moves the trained delta away from it."""
    params, a = ctx["params"], ctx["arr"]
    scheme = build_scheme(CFG, AdapterConfig(method="delta_a"))
    tp = scheme.init(jax.random.PRNGKey(0), base_params=params)
    tx = build_optimizer(OptimConfig(lr=1e-2, optimizer="sgd"))
    lat = jnp.asarray(a["lat"])
    step = make_train_step(scheme, CFG, tx, attn_impl="xla")
    tp, _, loss = step(tp, tx.init(tp), params, lat[:, :, :2], lat[:, :, 2:],
                       jnp.asarray(a["text"]), jnp.asarray(a["mask"]),
                       jax.random.PRNGKey(4))
    ref = np.asarray(tp["delta"])
    for rec in ctx["outs"]["cp"]["delta_step"]:
        np.testing.assert_allclose(float(rec["loss"]), float(loss), rtol=1e-5)
        scale = float(np.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(rec["delta"], ref, rtol=1e-4, atol=1e-4 * scale)
        assert np.abs(rec["delta_fault"] - ref).max() > 0.1 * scale


def test_backend_rule():
    """NCCL when every rank has a card of its own, gloo on the CPU or where
    ranks share a card; asking for NCCL there raises."""
    import torch

    from longcat_video_tta_tpu_torch.parallel.mesh import choose_backend

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    n_cards = torch.cuda.device_count()
    assert choose_backend(cpu, local_world=2) == "gloo"
    assert choose_backend(cuda, local_world=n_cards + 1) == "gloo"
    for dev in (cpu, cuda):
        with pytest.raises(ValueError, match="nccl needs one card per rank"):
            choose_backend(dev, "nccl", local_world=n_cards + 1)
    assert choose_backend(cpu, "gloo", local_world=4) == "gloo"
