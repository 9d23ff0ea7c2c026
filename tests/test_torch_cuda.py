"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a card. This file imports
nothing of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets JAX up for the rest of the
suite.)
"""

import importlib

import numpy as np
import pytest
import torch

from rafiki_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_dkv,
    flash_attention_dkv_plain,
    flash_attention_dq,
    flash_attention_dq_plain,
    flash_attention_lse,
    flash_attention_plain,
)

# the module (ops/__init__ re-exports the function under the same name)
flash_mod = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")


# S = 196 (no tile fits it), causal with Sq < Skv, and causal with dead rows
# (Skv < Sq: the first Sq - Skv rows see no key)
SHAPES = ((dict(b=2, h=3, sq=196), False),
          (dict(b=2, h=3, sq=40, skv=196), True),
          (dict(b=1, h=3, sq=196, skv=40), True))
TILES = [(bq, bk) for bq in flash_mod.BLOCK_Q_SIZES
         for bk in flash_mod.BLOCK_K_SIZES]


def _qkv(seed, b, h, sq, skv=None, dh=64):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, h, sq, dh), (b, h, skv, dh),
                                   (b, h, skv, dh)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_kernel_matches_plain(dtype, tol, dh):
    """On the card: the kernel against its plain version for every head dim
    and tile size it is built for, at the ViT attention length (S = 196,
    no tile fits it), causal with Sq < Skv, and with dead rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    for (shape, causal), (block_q, block_k) in (
            (s, t) for s in SHAPES for t in TILES):
        q, k, v = (t.to("cuda", dt) for t in _qkv(12, dh=dh, **shape))
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal, None, block_q, block_k)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_plain(q, k, v, causal)
        err = float((out.float() - ref.float()).abs().max())
        assert err <= tol, (shape, causal, block_q, block_k, err)
        if causal and shape["sq"] > shape["skv"]:
            assert float(out[:, :, :shape["sq"] - shape["skv"]].abs().max()) \
                == 0.0


def _rel_err(out, ref):
    """max |out - ref| over max(1, max |ref|): gradients are not O(1)."""
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,lse_tol", [("bfloat16", 1e-2, 1e-3),
                                               ("float32", 1e-5, 1e-5)])
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_training_kernels_match_plain(dtype, tol, lse_tol, dh):
    """On the card: K1 with the LSE (and its f32 output), K2 (dq) and K3
    (dk, dv) against their plain versions, for every head dim and tile pair the wrappers take, on
    the shapes above. K2/K3 get the plain forward's out and lse, so each
    kernel is held alone. bf16 tolerance: the kernels round P and dS to
    bf16 before the second products and the gradients to bf16 at the end
    (2^-8 relative each); f32: summation order and expf only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    for (shape, causal), (block_q, block_k) in (
            (s, t) for s in SHAPES for t in TILES):
        q, k, v = (t.to("cuda", dt) for t in _qkv(13, dh=dh, **shape))
        dout = _qkv(14, dh=dh, **shape)[0].to("cuda", dt)
        where = (shape, causal, block_q, block_k)
        counts = (flash_attention_lse.launches, flash_attention_dq.launches,
                  flash_attention_dkv.launches)

        out, lse, out32 = flash_attention_lse(q, k, v, causal, None,
                                              block_q, block_k)
        ref_out, ref_lse, ref_out32 = flash_attention_plain(
            q, k, v, causal, None, block_k, return_lse=True)
        delta = flash_mod._delta(ref_out32, dout)
        dq = flash_attention_dq(q, k, v, dout, ref_lse, delta, causal, None,
                                block_q, block_k)
        dk, dv = flash_attention_dkv(q, k, v, dout, ref_lse, delta, causal,
                                     None, block_q, block_k)
        torch.cuda.synchronize()
        assert (flash_attention_lse.launches, flash_attention_dq.launches,
                flash_attention_dkv.launches) == tuple(c + 1 for c in counts)
        out_tol = 1e-2 if dt == torch.bfloat16 else 1e-5
        assert float((out.float() - ref_out.float()).abs().max()) <= \
            out_tol, where
        # the f32 output: the kernel's P is rounded to bf16 for the PV
        # product, the plain version's is not
        assert out32.dtype == torch.float32
        assert float((out32 - ref_out32).abs().max()) <= out_tol, where
        live = torch.isfinite(ref_lse)
        assert torch.equal(torch.isfinite(lse), live), where
        assert float((lse[live] - ref_lse[live]).abs().max()) <= lse_tol, \
            where
        ref_dq = flash_attention_dq_plain(q, k, v, dout, ref_lse, delta,
                                          causal, None, block_k)
        ref_dk, ref_dv = flash_attention_dkv_plain(
            q, k, v, dout, ref_lse, delta, causal, None, block_q)
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                               ("dv", dv, ref_dv)):
            assert got.dtype == dt and got.shape == ref.shape
            assert bool(torch.isfinite(got).all()), (name, where)
            assert _rel_err(got, ref) <= tol, (name, where,
                                               _rel_err(got, ref))
        if causal and shape["sq"] > shape["skv"]:
            dead = shape["sq"] - shape["skv"]
            assert float(dq[:, :, :dead].abs().max()) == 0.0, where
            assert bool(torch.isinf(lse.view(q.shape[:3])[:, :, :dead])
                        .all()), where


@pytest.mark.cuda
def test_cuda_autograd_runs_the_training_kernels():
    """flash_attention under autograd launches K1 with the LSE once and K2
    and K3 once each; without grad it launches K1 alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.to("cuda", torch.bfloat16).requires_grad_()
               for t in _qkv(15, b=2, h=2, sq=196))
    counts = [f.launches for f in (flash_attention, flash_attention_lse,
                                   flash_attention_dq, flash_attention_dkv)]
    flash_attention(q, k, v).float().square().sum().backward()
    with torch.inference_mode():
        flash_attention(q.detach(), k.detach(), v.detach())
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(
        (flash_attention, flash_attention_lse, flash_attention_dq,
         flash_attention_dkv), counts)] == [1, 1, 1, 1]
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))
