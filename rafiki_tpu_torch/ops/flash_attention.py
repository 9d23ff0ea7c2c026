"""Blockwise (flash) attention, forward and backward: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``rafiki_tpu/ops/flash_attention.py``: ``flash_attention``
(a ``jax.custom_vjp`` there, a ``torch.autograd.Function`` here) and its
three Pallas kernels:

- K1, ``_fwd_kernel``: ``csrc/flash_fwd.cu``, wrapped by
  :func:`flash_attention` (no LSE: the primal path, as JAX's
  ``save_lse=False``) and :func:`flash_attention_lse` (the training
  forward: the per-row logsumexp too, compact as (B*H, Sq) f32, and the
  output in f32);
- K2, ``_dq_kernel``: ``csrc/flash_bwd.cu``, wrapped by
  :func:`flash_attention_dq` (the bf16 kernel also takes delta itself,
  from the forward's f32 output);
- K3, ``_dkv_kernel``: ``csrc/flash_bwd.cu``, wrapped by
  :func:`flash_attention_dkv`.

Each source's note says what it replaces, what bounds it and what its
design does about that. Each wrapper counts its launches in its own
``launches`` attribute. :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain` compute the same functions blockwise in
PyTorch (statistics in f32, the same masking and dead-row rule); a wrapper
runs its plain version for CPU tensors, and a CUDA tensor launches the
kernel or raises.

Under autograd (grad enabled and an input that requires it),
:func:`flash_attention` runs K1 with the LSE and saves q, k, v, the f32
output and lse; its backward runs K2, which for bf16 also takes
delta = rowsum(dO o O) in f32 (the JAX package computes it outside
Pallas, as :func:`_delta` does here for f32 and on the CPU), and K3. One
difference from the JAX package, on purpose: delta is taken from the
output before its rounding to the input type, not after. delta's error
is a per-row shift that the backward adds up over every key; where
dP - delta is a small difference (nearly uniform attention over similar
tokens, as at ViT-B/16's initialization), delta from the bf16 output
moved the q/k projection gradients by 58% of their norm against an f32
run, and delta from the f32 output by 5%, as much as plain bf16
attention (CPU measurement, scripts/torch_grad_precision.py; PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
BLOCK_Q_SIZES = (16, 32, 64)
BLOCK_K_SIZES = (16, 32, 64)
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30

_count_lock = threading.Lock()


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _visible(rows: torch.Tensor, cols: torch.Tensor, sq: int, skv: int,
             causal: bool) -> torch.Tensor:
    """(rows, cols) mask: inside the ragged edge and, when causal, on or
    below the end-aligned diagonal (query i sees key j iff
    j <= i + Skv - Sq)."""
    mask = (rows < sq) & (cols < skv)
    if causal:
        mask = mask & (cols <= rows + (skv - sq))
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          sm_scale: Optional[float] = None,
                          block_k: int = DEFAULT_BLOCK_K,
                          return_lse: bool = False):
    """Plain PyTorch flash attention over (B, H, S, Dh): online softmax
    over kv tiles of ``block_k`` keys with f32 statistics. Causal masking
    is end-aligned (query i sees key j iff j <= i + Skv - Sq); rows that see
    no key give exactly 0. With ``return_lse``, ``(out, lse, out_f32)``:
    also the per-row logsumexp of the scaled scores as (B*H, Sq) f32,
    +inf for rows that see no key, and the output before its rounding to
    the input type."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    qf = q.float() * _scale(q, sm_scale)
    kf, vf = k.float(), v.float()
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full(q.shape[:3] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0 in range(0, skv, block_k):
        kj, vj = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        cols = torch.arange(j0, j0 + kj.shape[2], device=q.device)[None, :]
        mask = _visible(rows, cols, sq, skv, causal)
        s = torch.where(mask, qf @ kj.transpose(-1, -2), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # re-mask: a row whose max is still NEG_INF would get exp(0) = 1
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vj
        m = m_new
    out_f32 = acc / l.clamp_min(1e-30)
    out = out_f32.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), math.inf)
    return out, lse.reshape(b * h, sq), out_f32


def _p_ds(qi, kj, vj, doi, lse_i, delta_i, mask, scale):
    """P = exp(scale q k^T - lse), re-masked, and dS = P o (dO v^T - delta)
    for one (q tile, kv tile) pair, in f32."""
    p = torch.where(mask, torch.exp(scale * (qi @ kj.transpose(-1, -2))
                                    - lse_i[..., None]), 0.0)
    ds = p * (doi @ vj.transpose(-1, -2) - delta_i[..., None])
    return p, ds


def flash_attention_dq_plain(q, k, v, dout, lse, delta, causal=False,
                             sm_scale=None, block_k=DEFAULT_BLOCK_K):
    """K2 in PyTorch: dq = scale * sum over kv tiles of dS K, in f32."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    scale = _scale(q, sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    lse4, delta4 = lse.view(b, h, sq), delta.view(b, h, sq)
    rows = torch.arange(sq, device=q.device)[:, None]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0 in range(0, skv, block_k):
        kj, vj = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        cols = torch.arange(j0, j0 + kj.shape[2], device=q.device)[None, :]
        mask = _visible(rows, cols, sq, skv, causal)
        _, ds = _p_ds(qf, kj, vj, dof, lse4, delta4, mask, scale)
        acc = acc + ds @ kj
    return (acc * scale).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal=False,
                              sm_scale=None, block_q=DEFAULT_BLOCK_Q):
    """K3 in PyTorch: dv = sum over q tiles of P^T dO and
    dk = scale * sum of dS^T Q, in f32."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    scale = _scale(q, sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    lse4, delta4 = lse.view(b, h, sq), delta.view(b, h, sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, sq, block_q):
        qi, doi = qf[:, :, i0:i0 + block_q], dof[:, :, i0:i0 + block_q]
        rows = torch.arange(i0, i0 + qi.shape[2], device=q.device)[:, None]
        mask = _visible(rows, cols, sq, skv, causal)
        p, ds = _p_ds(qi, kf, vf, doi, lse4[:, :, i0:i0 + block_q],
                      delta4[:, :, i0:i0 + block_q], mask, scale)
        dv = dv + p.transpose(-1, -2) @ doi
        dk = dk + ds.transpose(-1, -2) @ qi
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o O) in f32, as (B*H, Sq)."""
    b, h, sq, _ = out.shape
    return (dout.float() * out.float()).sum(-1).reshape(b * h, sq)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False,
                              sm_scale=None, block=DEFAULT_BLOCK_K):
    """The flash backward in PyTorch, blockwise with tiles of ``block``:
    (dq, dk, dv) in the input type from the forward's ``out`` (best its
    f32 output) and ``lse``. Rows that see no key (lse = +inf) get dq = 0
    and add nothing to dk or dv."""
    delta = _delta(out, dout)
    dq = flash_attention_dq_plain(q, k, v, dout, lse, delta, causal,
                                  sm_scale, block)
    dk, dv = flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal,
                                       sm_scale, block)
    return dq, dk, dv


@functools.cache
def _fwd_kernel():
    from rafiki_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.rafiki_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rafiki_flash_error.argtypes = [ctypes.c_int]
    lib.rafiki_flash_error.restype = ctypes.c_char_p
    return fn, lib.rafiki_flash_error


@functools.cache
def _bwd_kernels():
    from rafiki_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    lib.rafiki_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.rafiki_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.rafiki_flash_bwd_dq.restype = ctypes.c_int
    lib.rafiki_flash_bwd_dkv.restype = ctypes.c_int
    lib.rafiki_flash_bwd_error.argtypes = [ctypes.c_int]
    lib.rafiki_flash_bwd_error.restype = ctypes.c_char_p
    return (lib.rafiki_flash_bwd_dq, lib.rafiki_flash_bwd_dkv,
            lib.rafiki_flash_bwd_error)


def _view_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, row) strides of a (B, H, S, Dh) tensor in elements,
    with the stride of a dim of size 1 (never stepped) replaced by its
    contiguous value."""
    b, h, s, d = t.shape
    sb, sh, ss, _ = t.stride()
    return (sb if b > 1 else h * s * d, sh if h > 1 else s * d,
            ss if s > 1 else d)


def _tma_strides_ok(t: torch.Tensor) -> bool:
    """Whether TMA can walk a bf16 (B, H, S, Dh) tensor's layout: a dense
    last dim and other strides that are multiples of 16 bytes (8
    elements)."""
    return t.stride(3) == 1 and not any(s % 8 for s in _view_strides(t))


def _tma_readable(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels read ``t`` as it is: its layout
    (:func:`_tma_strides_ok`) and a base on a 16-byte boundary."""
    return _tma_strides_ok(t) and t.data_ptr() % 16 == 0


def _check_kernel_args(q, k, v, block_q: int, block_k: int,
                       dout: Optional[torch.Tensor] = None) -> list:
    """What the kernels do not take raises here, before any launch. bf16
    inputs may be strided views, as the projection's einsum hands them over
    (and its backward dO): every bf16 kernel reads through TMA, which takes
    any layout whose last dim is dense, whose other strides are multiples of
    16 bytes and whose base is 16-byte aligned; their :func:`_view_strides`
    are returned, in order. f32 inputs must be contiguous (an empty list is
    returned)."""
    named = [("q", q), ("k", k), ("v", v)]
    if dout is not None:
        named.append(("dout", dout))
    device, dtype = q.device, q.dtype
    strides = []
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, Dh), got "
                             f"{tuple(t.shape)}")
        if dtype == torch.bfloat16:
            if not _tma_strides_ok(t):
                raise ValueError(
                    f"{name} (strides {t.stride()}) must have a dense last "
                    "dim and other strides that are multiples of 16 bytes")
            strides.append(_view_strides(t))
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            # TMA and the kernels' 16-byte vectors
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    b, h, sq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if sq == 0 or k.shape[2] == 0 or b * h == 0:
        raise ValueError("empty attention")
    if block_q not in BLOCK_Q_SIZES or block_k not in BLOCK_K_SIZES:
        raise ValueError(f"block_q must be in {BLOCK_Q_SIZES} and block_k "
                         f"in {BLOCK_K_SIZES}")
    return strides


def _check_row_stats(q: torch.Tensor, **stats: torch.Tensor) -> None:
    """lse and delta: contiguous (B*H, Sq) f32 on q's device."""
    want = (q.shape[0] * q.shape[1], q.shape[2])
    for name, t in stats.items():
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {want} f32 tensor "
                             f"on {q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when every one lies on a CUDA device (the kernel runs); raises
    otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {sorted(kinds)}")
    return False


def _raise_on(rc: int, what: str, error_name) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{error_name(rc).decode()} ({rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _c_strides(views: list, *outs: torch.Tensor):
    """The (batch, head, row) strides of the checked inputs (``views``, as
    :func:`_check_kernel_args` returns them) and of the outputs, flat, for a
    C entry; None without views (f32: contiguous, the strides not read)."""
    if not views:
        return None
    flat = [s for bhs in views for s in bhs]
    flat += [s for t in outs for s in _view_strides(t)]
    return (ctypes.c_int64 * len(flat))(*flat)


def _launch_fwd(q, k, v, lse, out_f32, causal, sm_scale, block_q,
                block_k):
    views = _check_kernel_args(q, k, v, block_q, block_k)
    b, h, sq, dh = q.shape
    fn, error_name = _fwd_kernel()
    # q's layout where it is dense (the projection's (B, S, H, Dh) order,
    # which the output projection reads without a copy), else contiguous
    out = torch.empty_like(q)
    strides = _c_strides(views, out)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                out_f32.data_ptr() if out_f32 is not None else None, b, h,
                sq, k.shape[2], dh, float(_scale(q, sm_scale)), int(causal),
                int(q.dtype == torch.bfloat16), block_q, block_k, strides,
                _stream(q))
    _raise_on(rc, "flash_fwd", error_name)
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 for training: ``(out, lse, out_f32)`` with lse (B*H, Sq) f32,
    +inf for rows that see no key, and out_f32 the output before its
    rounding to the input type (``out`` itself for f32 inputs). The
    forward of the autograd op; ``flash_attention_lse.launches`` counts
    its kernel launches."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, sm_scale, block_k,
                                     return_lse=True)
    b, h, sq, _ = q.shape
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    out_f32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
               if q.dtype != torch.float32 else None)
    out = _launch_fwd(q, k, v, lse, out_f32, causal, sm_scale, block_q,
                      block_k)
    _count(flash_attention_lse)
    return out, lse, out if out_f32 is None else out_f32


def flash_attention_dq(q, k, v, dout, lse, out, causal: bool = False,
                       sm_scale: Optional[float] = None,
                       block_q: int = DEFAULT_BLOCK_Q,
                       block_k: int = DEFAULT_BLOCK_K
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dq, delta)`` from q, k, v, dO (B, H, S, Dh), the forward's
    lse ((B*H, Sq) f32) and its output ``out`` (the f32 output for bf16
    inputs, (B, H, Sq, Dh)), with delta = rowsum(dO o out) in f32 as
    (B*H, Sq), which K3 reads. The bf16 kernel takes delta itself as it
    loads each q tile; for f32 inputs :func:`_delta` (its plain version)
    computes it and the kernel reads it. ``flash_attention_dq.launches``
    counts its kernel launches."""
    if _on_cpu(q, k, v, dout, lse, out):
        delta = _delta(out, dout)
        return flash_attention_dq_plain(q, k, v, dout, lse, delta, causal,
                                        sm_scale, block_k), delta
    views = _check_kernel_args(q, k, v, block_q, block_k, dout)
    if (out.dtype != torch.float32 or out.shape != q.shape
            or out.device != q.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(q.shape)} f32 "
                         f"tensor on {q.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    _check_row_stats(q, lse=lse)
    bf16 = q.dtype == torch.bfloat16
    delta = (torch.empty(lse.shape, dtype=torch.float32, device=q.device)
             if bf16 else _delta(out, dout))
    b, h, sq, dh = q.shape
    dq_fn, _, error_name = _bwd_kernels()
    # in q's layout, as K1's output: the gradient of the projection's view
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(),
                   out.data_ptr() if bf16 else None, dq.data_ptr(), b, h,
                   sq, k.shape[2], dh, float(_scale(q, sm_scale)),
                   int(causal), int(bf16), block_q, block_k,
                   _c_strides(views, dq), _stream(q))
    _raise_on(rc, "flash_bwd_dq", error_name)
    _count(flash_attention_dq)
    return dq, delta


def flash_attention_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) from q, k, v, dO (B, H, S, Dh) and the row statistics
    lse and delta ((B*H, Sq) f32, delta as :func:`flash_attention_dq`
    returns it).
    ``flash_attention_dkv.launches`` counts its kernel launches."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal,
                                         sm_scale, block_q)
    views = _check_kernel_args(q, k, v, block_q, block_k, dout)
    _check_row_stats(q, lse=lse, delta=delta)
    b, h, sq, dh = q.shape
    _, dkv_fn, error_name = _bwd_kernels()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[2], dh,
                    float(_scale(q, sm_scale)), int(causal),
                    int(q.dtype == torch.bfloat16), block_q, block_k,
                    _c_strides(views, dk, dv), _stream(q))
    _raise_on(rc, "flash_bwd_dkv", error_name)
    _count(flash_attention_dkv)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX op's ``custom_vjp``: the forward stores
    the LSE and the f32 output (K1), the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_q, block_k):
        out, lse, out_f32 = flash_attention_lse(q, k, v, causal, sm_scale,
                                                block_q, block_k)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.args = (causal, sm_scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out_f32, lse = ctx.saved_tensors
        # bf16 K2 and K3 read the projection's views, as K1 did, and the
        # einsum backward's dO, through their tensor maps; a layout TMA
        # cannot walk (an expanded dO, a misaligned slice) and f32 are copied
        bf16 = q.dtype == torch.bfloat16
        q, k, v, dout = (t if bf16 and _tma_readable(t) else t.contiguous()
                         for t in (q, k, v, dout))
        dq, delta = flash_attention_dq(q, k, v, dout, lse, out_f32,
                                       *ctx.args)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


@torch.library.custom_op("rafiki::flash_fwd", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, sm_scale: Optional[float], block_q: int,
               block_k: int) -> torch.Tensor:
    """K1 without the LSE, as an operator of its own, so that
    ``torch.func.vmap`` reaches it through :func:`_flash_fwd_vmap` (a
    batched tensor has no data pointer for the kernel to read)."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, sm_scale, block_k)
    out = _launch_fwd(q, k, v, None, None, causal, sm_scale, block_q,
                      block_k)
    _count(flash_attention)
    return out


def _flash_fwd_vmap(info, in_dims, q, k, v, causal, sm_scale, block_q,
                    block_k):
    """The vmap rule of :func:`_flash_fwd`, the counterpart of XLA
    batching the Pallas call over ``jax.vmap``'s axis: the vmapped axis
    (T, the trials of a fused ensemble) moves to the front and folds into
    the batch, so ONE launch attends over all T·B rows, and the output
    unfolds to (T, B, H, S, Dh). The fold is a view where the stacked
    projection's strides merge, else a copy (counted in
    ``flash_attention.vmap_copies``)."""
    t = info.batch_size
    folded = []
    for x, d in zip((q, k, v), in_dims[:3]):
        x = x.expand(t, *x.shape) if d is None else x.movedim(d, 0)
        f = x.reshape(t * x.shape[1], *x.shape[2:])
        # (a view's _base is not kept under inference_mode: the storage
        # tells a view from a copy)
        if (f.untyped_storage().data_ptr()
                != x.untyped_storage().data_ptr()):
            with _count_lock:
                flash_attention.vmap_copies += 1
        folded.append(f)
    out = _flash_fwd(*folded, causal, sm_scale, block_q, block_k)
    return out.view(t, -1, *out.shape[1:]), 0


_flash_fwd.register_vmap(_flash_fwd_vmap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Flash attention over (B, H, S, Dh) tensors, differentiable.

    Under autograd (grad enabled and an input requiring it) it runs the
    training pair: K1 with the LSE forward, K2 and K3 backward. Otherwise
    (serving, ``torch.inference_mode``) K1 alone, writing no LSE:
    ``flash_attention.launches`` counts those launches. CPU tensors take
    the plain versions. bf16 inputs may be strided views (see
    :func:`_check_kernel_args`); f32 inputs are contiguous. ``block_q`` and
    ``block_k`` are tuning arguments that change nothing beyond rounding,
    as in the JAX package: they set the f32 kernels' and the plain
    versions' tiles, and the bf16 kernels use their own warpgroup tiles (64
    rows, 64 keys). Under ``torch.func.vmap`` (a fused ensemble's stacked
    forward) the vmapped axis folds into the batch and K1 runs once over
    every trial's rows (:func:`_flash_fwd_vmap`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale, block_q,
                                     block_k)
    _on_cpu(q, k, v)  # a device that is neither raises here
    return _flash_fwd(q, k, v, causal, sm_scale, block_q, block_k)


flash_attention.launches = 0
flash_attention.vmap_copies = 0
flash_attention_lse.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
