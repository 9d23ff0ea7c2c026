"""Blockwise (flash) attention forward: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

Counterpart of ``rafiki_tpu/ops/flash_attention.py`` (``flash_attention``
and its forward kernel ``_fwd_kernel``). The kernel is
``csrc/flash_fwd.cu`` (tensor-core ``mma.sync`` for bf16, scalar FMAs for
f32); its note says what it replaces, what bounds it and what its design
does about that. :func:`flash_attention_plain` computes
the same function blockwise in PyTorch (online softmax over kv tiles,
statistics in f32, same masking and dead-row rule) and is what the wrapper
runs for CPU tensors. A CUDA tensor launches the kernel or raises.

The backward kernels (``_dq_kernel``, ``_dkv_kernel``) and the LSE output
come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
BLOCK_Q_SIZES = (16, 32, 64)
BLOCK_K_SIZES = (16, 32, 64)
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30

_count_lock = threading.Lock()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          sm_scale: Optional[float] = None,
                          block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Plain PyTorch flash attention over (B, H, S, Dh): online softmax
    over kv tiles of ``block_k`` keys with f32 statistics. Causal masking
    is end-aligned (query i sees key j iff j <= i + Skv - Sq); rows that see
    no key give exactly 0."""
    sq, dh = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full(q.shape[:3] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0 in range(0, skv, block_k):
        kj, vj = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        cols = torch.arange(j0, j0 + kj.shape[2], device=q.device)[None, :]
        mask = cols < skv
        if causal:
            mask = mask & (cols <= rows + (skv - sq))
        s = torch.where(mask, qf @ kj.transpose(-1, -2), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # re-mask: a row whose max is still NEG_INF would get exp(0) = 1
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vj
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@functools.cache
def _kernel():
    from rafiki_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.rafiki_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rafiki_flash_error.argtypes = [ctypes.c_int]
    lib.rafiki_flash_error.restype = ctypes.c_char_p
    return fn, lib.rafiki_flash_error


def _check_kernel_args(q, k, v, block_q: int, block_k: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, Dh), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            # the bf16 kernel moves K/V rows in 16-byte vectors
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    b, h, sq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if sq == 0 or k.shape[2] == 0 or b * h == 0:
        raise ValueError("empty attention")
    if block_q not in BLOCK_Q_SIZES or block_k not in BLOCK_K_SIZES:
        raise ValueError(f"block_q must be in {BLOCK_Q_SIZES} and block_k "
                         f"in {BLOCK_K_SIZES}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Flash attention over (B, H, S, Dh) tensors. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel on the
    current stream (``flash_attention.launches`` counts those launches)."""
    if q.device.type == "cpu" and k.device == q.device == v.device:
        return flash_attention_plain(q, k, v, causal, sm_scale, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_kernel_args(q, k, v, block_q, block_k)
    b, h, sq, dh = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)
    fn, error_name = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, sq, k.shape[2], dh, float(scale), int(causal),
                int(q.dtype == torch.bfloat16), block_q, block_k, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: "
                           f"{error_name(rc).decode()} ({rc})")
    with _count_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
