"""A rank process of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_runner.py). It imports torch and the port only.

    python tests/torch_parallel_worker.py DIR RANK WORLD PORT

joins a gloo process group of WORLD CPU ranks at tcp://127.0.0.1:PORT,
reads DIR/tasks.json ({"mesh": [data, context, tensor], "tasks": [...]})
and DIR/in.npz, runs each task and writes its arrays to
DIR/<task>.rank<RANK>.npz. Under torchrun (``runner`` mode):

    torchrun ... tests/torch_parallel_worker.py runner OUT_JSON ARGV...

counts this rank's attention launches on the plain path (what the
kernels launch on the card) while the runner runs ARGV, and writes them
with the runner's summary to OUT_JSON.<rank>.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

from longcat_video_tta_tpu_torch.config import (  # noqa: E402
    AdapterConfig,
    CFGReuseConfig,
    MeshConfig,
    OptimConfig,
    PABConfig,
    longcat_tiny,
)
from longcat_video_tta_tpu_torch.parallel import (  # noqa: E402
    build_mesh,
    cp_self_attention,
    init_distributed,
    ring_self_attention,
)
from longcat_video_tta_tpu_torch.parallel.context_attention import shard_tokens  # noqa: E402

CFG = dataclasses.replace(longcat_tiny().dit, hidden_size=64, num_heads=2, ffn_dim=128)


def unflatten(arrs, prefix):
    """{"params/a/b": x} -> {"a": {"b": x}} (the reference's tree)."""
    tree = {}
    for key, val in arrs.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def t(x):
    return torch.from_numpy(np.asarray(x)).clone()


class Counter:
    """Plain-path attention calls of this rank: each forward (a ring
    chunk or a whole call) and each backward kernel's call, as the card
    would launch B1, B3 and B2."""

    def __init__(self):
        from longcat_video_tta_tpu_torch.ops import flash_attention as fa
        from longcat_video_tta_tpu_torch.parallel import context_attention as ca

        self.n = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        fwd, bwd = fa.attention_reference, fa.FlashAttentionFunction.backward
        dq, dkv = ca.flash_chunk_dq, ca.flash_chunk_dkv

        def count_fwd(*a, **k):
            self.n["flash_fwd"] += 1
            return fwd(*a, **k)

        def count_bwd(ctx, do):
            out = bwd(ctx, do)
            self.n["flash_bwd_dq"] += ctx.needs_input_grad[0]
            self.n["flash_bwd_dkv"] += ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
            return out

        def count(name, fn):
            def wrapped(*a, **k):
                self.n[name] += 1
                return fn(*a, **k)
            return wrapped

        fa.attention_reference = count_fwd
        fa.FlashAttentionFunction.backward = staticmethod(count_bwd)
        ca.flash_chunk_dq = count("flash_bwd_dq", dq)
        ca.flash_chunk_dkv = count("flash_bwd_dkv", dkv)


# ---------------------------------------------------------------------------
# tasks: each returns {name: array} for this rank
# ---------------------------------------------------------------------------


def task_mesh(mesh, arrs):
    c = mesh.coords
    return {"coords": np.array([c["data"], c["context"], c["tensor"]]),
            "sizes": np.array([mesh.size(a) for a in mesh.axis_names]),
            "members": np.array([mesh.members[a] for a in mesh.axis_names])}


def task_stripes(mesh, arrs):
    """A message above ``STRIPE_MIN_BYTES`` through the context group's
    stripes: the all-reduce (sum, max) and one ring rotation, beside the
    same all-reduce on the group alone."""
    import torch.distributed as dist

    from longcat_video_tta_tpu_torch.parallel import collectives as col

    g = mesh.group("context")
    x = t(arrs["stripe_x"])[mesh.index("context")]
    assert x.numel() * x.element_size() >= col.STRIPE_MIN_BYTES
    assert len(col._pieces(x, g)) == col.STRIPES
    whole = x.clone()
    dist.all_reduce(whole, group=g)
    return {"sum": col.all_reduce(x, g).numpy(), "max": col.all_reduce(x, g, "max").numpy(),
            "sum_whole": whole.numpy(), "shift": col.ring_shift([x, 2 * x], g)[1].numpy()}


def task_attention(mesh, arrs):
    """cp and ring attention (ncond 0 and 24, 64 tokens), the ring's
    gradients (ncond 12), the decode shapes, the kv_valid bucket."""
    out = {}
    sh = lambda x: shard_tokens(t(x), mesh)
    q, k, v = (sh(arrs[f"attn_{n}"]) for n in "qkv")
    for ncond in (0, 24):
        out[f"cp{ncond}"] = cp_self_attention(q, k, v, mesh, num_cond_tokens=ncond).numpy()
        out[f"ring{ncond}"] = ring_self_attention(q, k, v, mesh,
                                                  num_cond_tokens=ncond).numpy()
    gq, gk, gv = (sh(arrs[f"grad_{n}"]).requires_grad_(True) for n in "qkv")
    (ring_self_attention(gq, gk, gv, mesh, num_cond_tokens=12)
     * sh(arrs["grad_w"])).sum().backward()
    out.update(dq=gq.grad.numpy(), dk=gk.grad.numpy(), dv=gv.grad.numpy())
    dq_, dk_, dv_ = (sh(arrs[f"dec_{n}"]) for n in "qkv")
    out["dec0"] = ring_self_attention(dq_, dk_, dv_, mesh, num_cond_tokens=0).numpy()
    out["dec16"] = ring_self_attention(dq_, dk_, dv_, mesh, num_cond_tokens=16).numpy()
    out["dec_cp16"] = cp_self_attention(dq_, dk_, dv_, mesh, num_cond_tokens=16).numpy()
    kq, kk, kv = (sh(arrs[f"kv_{n}"]).requires_grad_(True) for n in "qkv")
    o = ring_self_attention(kq, kk, kv, mesh, num_cond_tokens=16, kv_valid=44)
    w = torch.zeros(o.shape)
    wl = t(arrs["kv_w"])  # [B, 44, H, D] on the valid tokens
    lo = mesh.index("context") * o.shape[1]
    n_valid = max(0, min(44 - lo, o.shape[1]))
    w[:, :n_valid] = wl[:, lo:lo + n_valid]
    (o * w).sum().backward()
    out.update(kv_o=o.detach().numpy(), kv_dq=kq.grad.numpy(), kv_dk=kk.grad.numpy(),
               kv_dv=kv.grad.numpy())
    return out


def _dit(arrs, mesh=None):
    from longcat_video_tta_tpu_torch.models.weights import load_dit_from_numpy
    from longcat_video_tta_tpu_torch.parallel.sharding import parallelize

    dit = load_dit_from_numpy(unflatten(arrs, "params"), CFG, device="cpu")
    return dit if mesh is None else parallelize(dit, mesh, "longcat")


def _rows(x, mesh):
    """This data rank's batch rows."""
    n, d = mesh.size("data"), mesh.index("data")
    m = x.shape[0] // n
    return x[d * m:(d + 1) * m]


def task_forward(mesh, arrs):
    """The DiT forward at this rank's batch rows, and the bucketed forward
    and the bucketed cached decode (one rank per data line)."""
    dit = _dit(arrs, mesh)
    lat, text, mask = (_rows(t(arrs[k]), mesh) for k in ("lat", "text", "mask"))
    B = lat.shape[0]
    with torch.no_grad():
        out = {"fwd": dit(lat, torch.full((B,), 500.0), text, mask,
                          num_cond_latents=2).numpy()}
        if mesh.size("data") == 1:
            lat_p = t(arrs["lat_p"])
            ts = torch.cat([torch.zeros((B, 2)), torch.full((B, 6), 500.0)], dim=1)
            out["bucket"] = dit(lat_p, ts, text, mask, num_cond_latents=2,
                                num_valid_latents=4).numpy()
            cache = dit.precompute_cond_cache(lat[:, :, :2], text, mask)
            out["cache_bucket"] = dit.forward_with_cache(
                t(arrs["noise_p"]), torch.full((B,), 500.0), text, mask, cache,
                num_cond_latents=2, num_valid_latents=3).numpy()
    return out


def _sample(dit, arrs, **kw):
    from longcat_video_tta_tpu_torch.config import longcat_tiny as tiny
    from longcat_video_tta_tpu_torch.pipeline.sampler import (
        sample_latents,
        sample_latents_segmented,
    )

    seg = kw.pop("segment_steps", 0)
    fn = sample_latents_segmented if seg else sample_latents
    extra = {"segment_steps": seg} if seg else {}
    emb, msk = t(arrs["text"])[:1], t(arrs["mask"])[:1]
    with torch.no_grad():
        return fn(dit, tiny().scheduler, emb, msk, emb, msk, 4.0, num_gen_latents=2,
                  lat_h=8, lat_w=16, cond_latents=t(arrs["lat"])[:1, :, :2],
                  use_kv_cache=True, init_noise=t(arrs["init_noise"]), **extra,
                  **kw).numpy()


def task_sample(mesh, arrs):
    """sample_latents under the mesh: plain, PAB every 1 / 2 / segmented,
    CFG reuse every 1 / 2 / segmented."""
    dit = _dit(arrs, mesh)
    pab2 = PABConfig(every=2, start_frac=0.25, end_frac=1.0)
    r2 = CFGReuseConfig(every=2, start_frac=0.25, end_frac=1.0)
    return {"plain2": _sample(dit, arrs, num_steps=2),
            "plain4": _sample(dit, arrs, num_steps=4),
            "pab1": _sample(dit, arrs, num_steps=4, pab_cfg=PABConfig(every=1)),
            "pab2": _sample(dit, arrs, num_steps=4, pab_cfg=pab2),
            "pab2_seg": _sample(dit, arrs, num_steps=4, pab_cfg=pab2, segment_steps=2),
            "cfgr1": _sample(dit, arrs, num_steps=4, cfgr_cfg=CFGReuseConfig(every=1)),
            "cfgr2": _sample(dit, arrs, num_steps=4, cfgr_cfg=r2),
            "cfgr2_seg": _sample(dit, arrs, num_steps=4, cfgr_cfg=r2, segment_steps=2)}


def _step(dit, arrs, method, sigma, noise, opt="sgd", lr=1e-4):
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
    from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_step

    mesh = dit.mesh
    scheme = build_scheme(CFG, AdapterConfig(method=method))
    tx = build_optimizer(OptimConfig(lr=lr, optimizer=opt))
    tp = scheme.init("cpu", dit=dit, generator=torch.Generator().manual_seed(0))
    state = tx.init(tp)
    lat, text, mask = (_rows(t(arrs[k]), mesh) for k in ("lat", "text", "mask"))
    tp, state, loss = train_step(scheme, dit, tx, tp, state, lat[:, :, :2], lat[:, :, 2:],
                                 text, mask, sigma=_rows(sigma, mesh),
                                 noise=_rows(noise, mesh))
    return tp, loss


def task_full_step(mesh, arrs):
    """One full SGD step (every DiT tensor trains; context, tensor and data
    axes inside) on the reference's draws; its loss and the updated
    tensors gathered whole."""
    from longcat_video_tta_tpu_torch.parallel.sharding import unshard

    dit = _dit(arrs, mesh)
    tp, loss = _step(dit, arrs, "full", t(arrs["sigma"]), t(arrs["noise"]), lr=1e-2)
    whole = unshard(dit, tp)
    return {"loss": loss.numpy(), **{f"p/{k}": v.numpy() for k, v in whole.items()}}


def task_delta_step(mesh, arrs):
    """One delta_a SGD step on the reference's draws: the loss and the
    trained delta; with the gradient all-reduce left out (the planted
    fault) too."""
    from longcat_video_tta_tpu_torch.tta import engine

    dit = _dit(arrs, mesh)
    sig, noi = t(arrs["sigma"]), t(arrs["noise"])
    tp, loss = _step(dit, arrs, "delta_a", sig, noi, opt="sgd", lr=1e-2)
    out = {"loss": loss.numpy(), "delta": tp["delta"].numpy()}
    keep = engine.all_reduce_grads
    engine.all_reduce_grads = lambda grads, group, mean=False: grads
    try:
        tp, _ = _step(dit, arrs, "delta_a", sig, noi, opt="sgd", lr=1e-2)
    finally:
        engine.all_reduce_grads = keep
    out["delta_fault"] = tp["delta"].numpy()
    return out


def _lane_chunk(mesh, arrs, pre, acfg):
    """This data rank's lanes of a batched chunk on the reference's draws
    (each lane its own adapter: no collective)."""
    from longcat_video_tta_tpu_torch.tta.adapters import build_scheme
    from longcat_video_tta_tpu_torch.tta.engine import build_optimizer, train_chunk_batched

    dit = _dit(arrs)
    V = arrs[f"{pre}_cond"].shape[0]
    n, d = mesh.size("data"), mesh.index("data")
    lanes = list(range(d * V // n, (d + 1) * V // n))
    scheme = build_scheme(CFG, acfg)
    tx = build_optimizer(OptimConfig(lr=1e-2, optimizer="adamw"))
    tps = {key[len(pre) + 4:]: t(arrs[key])[lanes] for key in arrs
           if key.startswith(f"{pre}_tp/")}
    steps = arrs[f"{pre}_sigma"].shape[1]
    draws = [[(t(arrs[f"{pre}_sigma"])[v, s], t(arrs[f"{pre}_noise"])[v, s])
              for v in lanes] for s in range(steps)]
    sel = lambda key: t(arrs[f"{pre}_{key}"])[lanes]
    tps, _, losses, _ = train_chunk_batched(
        scheme, dit, tx, tps, tx.init(tps), sel("cond"), sel("train"), sel("emb"),
        sel("mask"), steps=steps, draws=draws)
    return {"lanes": np.array(lanes), "losses": losses.numpy(),
            **{f"tp/{k}": v.numpy() for k, v in tps.items()}}


def task_vp_chunk(mesh, arrs):
    return _lane_chunk(mesh, arrs, "vp", AdapterConfig(method="delta_b", num_groups=2))


def task_dcn_chunk(mesh, arrs):
    return _lane_chunk(mesh, arrs, "dcn", AdapterConfig(method="delta_a"))


def task_sample_plain(mesh, arrs):
    """sample_latents (2 steps) under the mesh."""
    return {"plain2": _sample(_dit(arrs, mesh), arrs, num_steps=2)}


TASKS = {"mesh": task_mesh, "stripes": task_stripes, "attention": task_attention, "forward": task_forward,
         "sample": task_sample, "full_step": task_full_step,
         "delta_step": task_delta_step, "vp_chunk": task_vp_chunk,
         "dcn_chunk": task_dcn_chunk, "sample_plain": task_sample_plain}


def run_tasks(folder, rank, world, port):
    with open(os.path.join(folder, "tasks.json")) as f:
        spec = json.load(f)
    init_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu",
                     timeout_s=120)
    mesh = build_mesh(MeshConfig(*spec["mesh"]), device="cpu")
    arrs = dict(np.load(os.path.join(folder, "in.npz"), allow_pickle=False))
    for name in spec["tasks"]:
        out = TASKS[name](mesh, arrs)
        np.savez(os.path.join(folder, f"{name}.rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def run_runner(out_json, argv):
    """One torchrun rank of the runner on longcat_tiny with per-block
    remat (the launch derivations assume it), its plain-path attention
    calls counted."""
    from longcat_video_tta_tpu_torch import config
    from longcat_video_tta_tpu_torch.runners import run_tta

    get = config.get_model_config

    def remat_on(preset):
        cfg = get(preset)
        return dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, remat=True))

    config.get_model_config = remat_on
    counter = Counter()
    writes = []  # the output writers this rank called

    def record(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            writes.append(name)
            return fn(*a, **k)
        setattr(mod, name, wrapped)

    from longcat_video_tta_tpu_torch.data import video_io
    from longcat_video_tta_tpu_torch.utils import checkpoint

    for name in ("save_checkpoint", "save_results", "save_config", "save_adapter_state"):
        record(checkpoint, name)
    record(video_io, "save_video")
    record(run_tta, "make_synthetic_dataset")
    summary = run_tta.main(argv)
    rank = int(os.environ.get("RANK", "0"))
    with open(f"{out_json}.{rank}", "w") as f:
        json.dump({"launches": counter.n, "summary": summary, "writes": writes}, f)


if __name__ == "__main__":
    if sys.argv[1] == "runner":
        run_runner(sys.argv[2], sys.argv[3:])
    else:
        run_tasks(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
