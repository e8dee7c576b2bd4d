"""The q/k prologue of LongCat's attention: per-head RMSNorm and, for
self-attention, half-split 3D RoPE of q and k in one pass
(``qk_norm_rope``), through the hand-written kernels of
``csrc/qk_norm_rope.cu`` on the card.

The kernels replace no TPU kernel: the JAX package writes ``rms_norm``
then ``apply_rope`` (``longcat_video_tta_tpu/ops/layers.py``) and leaves
their fusion to XLA. On CPU tensors ``qk_norm_rope`` runs exactly that
chain (``ops/layers.py``); on CUDA tensors it runs
``QKNormRopeFunction``, whose forward is the dispatcher op
``lc_port::qk_norm_rope`` (so that a selective checkpoint policy sees it
as one op, recomputed like the others) and whose backward is a kernel
too. There is no fallback from one to the other.

Precision. The chain rounds to the 16-bit type after the norm and rotates
in 16 bits with cos/sin rounded to it; the kernel stays in fp32 from the
load to its one rounding at the store: the same arithmetic in the same
order, rounded once. ``norm_rope_reference`` and
``norm_rope_backward_reference`` are that arithmetic in plain PyTorch:
the versions the kernels are held to, and what the function runs on CPU
tensors.

Layouts: q, k [B, ..., H, D] with contiguous [H, D] rows (views cut from
a fused projection pass their strides); cos, sin [T, D/2] (any shape of
T * D/2 values, T the tokens between the batch and the head axis) fp32;
a weight [D], or [V, D] with row b of the batch taking lane b % V
(``ops/layers.py::lane_rows``)."""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..utils.spans import span
from . import flash_attention as fa
from .layers import apply_rope, lane_rows, rms_norm

SOURCE = fa.QK_NORM_SOURCE
HEAD_DIMS = fa.HEAD_DIMS  # the attention kernels' head dims

# Launches since the last reset; incremented only where a kernel launches.
launches = 0      # lc_qk_norm_rope_fwd (q and k in one)
bwd_launches = 0  # lc_qk_norm_rope_bwd (and its dw sum, when a weight trains)
_lib = None
_rows_per_cta = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic)
# ---------------------------------------------------------------------------


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in fp64 when it is fp64 (a float64 evaluation)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _row_weight(w: torch.Tensor, B: int) -> torch.Tensor:
    """[D] or [V, D] -> fp32 [B or 1, 1, 1, D]."""
    r = lane_rows(_wide(w), 1, B)
    return r[:, None, None, :]


def _rotate(v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            transpose: bool = False) -> torch.Tensor:
    """The half-split rotation of fp32 rows v [B, T, H, D] by the fp32
    tables [T, D/2] (its transpose with ``transpose``)."""
    half = v.shape[-1] // 2
    c = _wide(cos.reshape(1, -1, 1, half))
    s = _wide(sin.reshape(1, -1, 1, half))
    if transpose:
        s = -s
    a, b = v[..., :half], v[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, ..., H, D] -> [B, T, H, D] (a view where the token axes merge)."""
    return x.reshape(x.shape[0], -1, x.shape[-2], x.shape[-1])


def _rstd(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)


def norm_rope_reference(x: torch.Tensor, w: torch.Tensor, cos: Optional[torch.Tensor],
                        sin: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """x [B, T, H, D] -> y [B, T, H, D] in x's dtype: rstd = rsqrt(mean(x^2)
    + eps), y = R(x * rstd * w) in fp32 (R the rotation by cos/sin, or
    none), rounded once."""
    xf = _wide(x)
    v = xf * _rstd(xf, eps) * _row_weight(w, x.shape[0])
    if cos is not None:
        v = _rotate(v, cos, sin)
    return v.to(x.dtype)


def norm_rope_backward_reference(x, w, cos, sin, dy, eps: float, need_dw: bool):
    """(dx in x's dtype, dw fp32 [V, D] or None) of ``norm_rope_reference``
    from its input x and the output gradient dy [B, T, H, D]: rstd from x
    as the forward has it, du = R^T dy, xh = x * rstd, g = w * du,
    dx = rstd * (g - xh * mean(xh * g)), dw = the sum of xh * du over the
    rows of each lane."""
    B, D = x.shape[0], x.shape[-1]
    du = _wide(dy)
    if cos is not None:
        du = _rotate(du, cos, sin, transpose=True)
    xf = _wide(x)
    r = _rstd(xf, eps)
    xh = xf * r
    g = _row_weight(w, B) * du
    dx = r * (g - xh * (xh * g).mean(dim=-1, keepdim=True))
    dw = None
    if need_dw:
        V = 1 if w.ndim == 1 else w.shape[0]
        dw = (xh * du).reshape(B // V, V, -1, D).sum(dim=(0, 2))
        if w.ndim == 1:
            dw = dw[0]
    return dx.to(x.dtype), dw


# ---------------------------------------------------------------------------
# Build, binding and launches
# ---------------------------------------------------------------------------

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# xq, xk, yq, yk, wq, wk, cos, sin, B, H, D, Tq, Tk, Vq, Vk,
# q_bs, q_ts, k_bs, k_ts, eps, dtype, stream
_FWD_ARGTYPES = [_PTR] * 8 + [_INT] * 7 + [_I64] * 4 + [ctypes.c_float, _INT, _PTR]
# xq, xk, dyq, dyk, dxq, dxk, wq, wk, cos, sin, pq, pk, dwq, dwk,
# B, H, D, Tq, Tk, Vq, Vk, q_bs, q_ts, k_bs, k_ts, eps, dtype, stream
_BWD_ARGTYPES = [_PTR] * 14 + [_INT] * 7 + [_I64] * 4 + [ctypes.c_float, _INT, _PTR]


def load_library(source: str = SOURCE) -> str:
    """Build ``source`` if needed (``flash_attention.build_libraries``) and
    bind its entry points; every later launch uses them. Returns the
    library's path."""
    global _lib, _rows_per_cta
    path = fa.build_libraries((source,))[0][0]
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "lc_qk_norm_rope_fwd_launch"):
        raise RuntimeError(f"{source} exports no q/k prologue entry point")
    lib.lc_qk_norm_rope_fwd_launch.argtypes = _FWD_ARGTYPES
    lib.lc_qk_norm_rope_bwd_launch.argtypes = _BWD_ARGTYPES
    lib.lc_qk_norm_rope_fwd_launch.restype = ctypes.c_int
    lib.lc_qk_norm_rope_bwd_launch.restype = ctypes.c_int
    lib.lc_qk_norm_rope_rows_per_cta.restype = ctypes.c_int
    _rows_per_cta = lib.lc_qk_norm_rope_rows_per_cta()
    _lib = lib
    return path


def _library():
    if _lib is None:
        load_library(SOURCE)
    return _lib


def _weight(w: torch.Tensor, B: int, D: int) -> torch.Tensor:
    """fp32 contiguous [V, D] of a [D] or [V, D] weight."""
    V = 1 if w.ndim == 1 else w.shape[0]
    if w.shape[-1] != D or w.ndim > 2 or B % V:
        raise ValueError(f"qk_norm_rope: a weight is [D] or [V, D] with V dividing the "
                         f"batch {B}; got {tuple(w.shape)} for D {D}")
    return w.float().reshape(V, D).contiguous()


def _check_rows(name: str, x: torch.Tensor) -> None:
    """[B, T, H, D] with contiguous, 16-byte aligned [H, D] rows (the
    kernels read 16 bytes per lane)."""
    esz, D = x.element_size(), x.shape[-1]
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"qk_norm_rope: {name} must have contiguous [H, D] rows, got "
                         f"strides {tuple(x.stride())}")
    if x.data_ptr() % 16 or (x.stride(0) * esz) % 16 or (x.stride(1) * esz) % 16:
        raise ValueError(f"qk_norm_rope: {name} needs 16-byte aligned rows (strides "
                         f"{tuple(x.stride())}, ptr {x.data_ptr()})")


def _check_inputs(q, k, cos, sin):
    """Raise on what the kernels do not take; return (cos, sin) as fp32
    contiguous [T, D/2], or (None, None)."""
    B, Tq, H, D = q.shape
    if q.dtype not in fa._KERNEL_DTYPES or k.dtype != q.dtype:
        raise TypeError(f"qk_norm_rope takes bf16 or fp16 q and k of one dtype, got "
                        f"{q.dtype}, {k.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"qk_norm_rope takes head_dim in {HEAD_DIMS}, got {D}")
    if k.shape[0] != B or k.shape[2:] != (H, D) or k.device != q.device:
        raise ValueError(f"qk_norm_rope: q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share the batch, the heads, head_dim and the device")
    if B > 65535 or Tq * H >= 2 ** 31 or k.shape[1] * H >= 2 ** 31:
        raise ValueError(f"qk_norm_rope: q {tuple(q.shape)} / k {tuple(k.shape)} exceed "
                         f"the grid")
    _check_rows("q", q)
    _check_rows("k", k)
    if cos is None:
        return None, None
    if k.shape[1] != Tq or cos.numel() != Tq * D // 2 or sin.numel() != cos.numel():
        raise ValueError(f"qk_norm_rope: the rotation needs q and k of one token count and "
                         f"[T, D/2] tables; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"cos {tuple(cos.shape)}")
    return (cos.reshape(Tq, D // 2).float().contiguous(),
            sin.reshape(Tq, D // 2).float().contiguous())


def _kernel_forward(q, k, wq, wk, cos, sin, eps: float):
    """Launch the forward kernel on q and k [B, T, H, D] on the current
    stream -> (yq, yk)."""
    global launches
    cos, sin = _check_inputs(q, k, cos, sin)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    wq, wk = _weight(wq, B, D), _weight(wk, B, D)
    yq, yk = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for T in (Tq, Tk))
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.lc_qk_norm_rope_fwd_launch(
            q.data_ptr(), k.data_ptr(), yq.data_ptr(), yk.data_ptr(), wq.data_ptr(),
            wk.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            B, H, D, Tq, Tk, wq.shape[0], wk.shape[0], q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), float(eps), fa._KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qk_norm_rope forward launch failed: cudaError {rc}")
    launches += 1
    return yq, yk


def _kernel_backward(q, k, wq, wk, cos, sin, dyq, dyk, eps: float, need, need_w):
    """Launch the backward kernel (and the dw sum) on the current stream:
    ``need`` / ``need_w`` say which of q, k and of their weights want a
    gradient -> (dq, dk, dwq, dwk), None where not wanted."""
    global bwd_launches
    cos, sin = _check_inputs(q, k, cos, sin)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dev = q.device
    w32 = [_weight(w, B, D) for w in (wq, wk)]
    dys = [None if dy is None else dy.reshape(x.shape).contiguous()
           for dy, x in ((dyq, q), (dyk, k))]
    side = [need[i] or need_w[i] for i in range(2)]
    dx = [torch.empty((B, x.shape[1], H, D), dtype=x.dtype, device=dev) if side[i] else None
          for i, x in enumerate((q, k))]
    lib = _library()
    nblk = [-(-x.shape[1] * H // _rows_per_cta) for x in (q, k)]
    part = [torch.empty((B, nblk[i], D), dtype=torch.float32, device=dev) if need_w[i]
            else None for i in range(2)]
    dw = [torch.empty_like(w32[i]) if need_w[i] else None for i in range(2)]
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.lc_qk_norm_rope_bwd_launch(
            q.data_ptr(), k.data_ptr(), ptr(dys[0]), ptr(dys[1]), ptr(dx[0]), ptr(dx[1]),
            w32[0].data_ptr(), w32[1].data_ptr(), ptr(cos), ptr(sin), ptr(part[0]),
            ptr(part[1]), ptr(dw[0]), ptr(dw[1]), B, H, D, Tq, Tk, w32[0].shape[0],
            w32[1].shape[0], q.stride(0), q.stride(1), k.stride(0), k.stride(1), float(eps),
            fa._KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qk_norm_rope backward launch failed: cudaError {rc}")
    bwd_launches += 1
    dw = [None if d is None else d.reshape(w.shape) for d, w in zip(dw, (wq, wk))]
    return (dx[0] if need[0] else None, dx[1] if need[1] else None, dw[0], dw[1])


# ---------------------------------------------------------------------------
# The op, its autograd and the entry
# ---------------------------------------------------------------------------


@torch.library.custom_op("lc_port::qk_norm_rope", mutates_args=())
def qk_norm_rope_op(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B, T, H, D] -> (yq, yk): one launch of the forward kernel for
    CUDA tensors, ``norm_rope_reference`` on each for CPU tensors."""
    if not q.is_cuda:
        return (norm_rope_reference(q, wq, cos, sin, eps),
                norm_rope_reference(k, wk, cos, sin, eps))
    return _kernel_forward(q, k, wq, wk, cos, sin, eps)


@qk_norm_rope_op.register_fake
def _(q, k, wq, wk, cos, sin, eps):
    return q.new_empty(q.shape), k.new_empty(k.shape)


class QKNormRopeFunction(torch.autograd.Function):
    """Differentiable q/k prologue: ``forward(q, k, wq, wk, cos, sin,
    eps)`` -> (yq, yk) contiguous, shaped as q and k. The forward runs
    ``qk_norm_rope_op`` and keeps q and k (the views it read; the backward
    kernel recomputes each row's rstd from them) and the weights; the
    backward launches the backward kernel for the sides that want a
    gradient, with dw only for a weight that requires one. CPU tensors run
    the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, wq, wk, cos, sin, eps):
        qr, kr = _rows(q), _rows(k)
        yq, yk = qk_norm_rope_op(qr, kr, wq, wk, cos, sin, float(eps))
        ctx.save_for_backward(qr, kr, wq, wk, cos, sin)
        ctx.shapes, ctx.eps = (q.shape, k.shape), float(eps)
        return yq.view(q.shape), yk.view(k.shape)

    @staticmethod
    def backward(ctx, dyq, dyk):
        qr, kr, wq, wk, cos, sin = ctx.saved_tensors
        need, need_w = ctx.needs_input_grad[:2], ctx.needs_input_grad[2:4]
        if qr.is_cuda:
            dq, dk, dwq, dwk = _kernel_backward(qr, kr, wq, wk, cos, sin, dyq, dyk, ctx.eps,
                                                need, need_w)
        else:
            dq, dwq = norm_rope_backward_reference(qr, wq, cos, sin, _rows(dyq), ctx.eps,
                                                   need_w[0])
            dk, dwk = norm_rope_backward_reference(kr, wk, cos, sin, _rows(dyk), ctx.eps,
                                                   need_w[1])
        grads = [None if d is None or not n else d.view(shape)
                 for d, n, shape in ((dq, need[0], ctx.shapes[0]),
                                     (dk, need[1], ctx.shapes[1]))]
        dws = [None if d is None else d.to(w.dtype) for d, w in ((dwq, wq), (dwk, wk))]
        return grads[0], grads[1], dws[0], dws[1], None, None, None


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
                 wk: torch.Tensor, cos: Optional[torch.Tensor] = None,
                 sin: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """RMSNorm over the head axis of q and k with the weights wq and wk,
    then, when ``cos`` is given, the half-split rotation of both by
    cos/sin [n_t, n_hw, D/2] (q, k [B, n_t, n_hw, H, D] then; without it
    any [B, ..., H, D], k with its own token count) -> (q, k), each shaped
    as its input. CPU tensors run ``rms_norm`` then ``apply_rope``
    (``ops/layers.py``) unchanged; CUDA tensors one forward kernel for
    both, inside the ``op.rms_norm`` span (which then holds the rotation
    too): through ``QKNormRopeFunction`` when autograd records and an
    input needs a gradient, else straight (as ``ops/attention.py`` does:
    the sampler pays no dispatcher op)."""
    if not q.is_cuda:
        q, k = rms_norm(q, wq, eps), rms_norm(k, wk, eps)
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return q, k
    with span("op.rms_norm"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, wq, wk)):
            return QKNormRopeFunction.apply(q, k, wq, wk, cos, sin, eps)
        yq, yk = _kernel_forward(_rows(q), _rows(k), wq, wk, cos, sin, eps)
        return yq.view(q.shape), yk.view(k.shape)
