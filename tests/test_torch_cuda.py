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
    """On the card: K1 with the LSE (and its f32 output), K2 (dq, and
    delta) and K3 (dk, dv) against their plain versions, for every head
    dim and tile pair the wrappers take, on the shapes above. K2/K3 get
    the plain forward's out and lse (K3 PyTorch's delta), so each kernel
    is held alone. bf16 tolerance: K3 rounds P to bf16 before P^T dO
    (the training forward's P V and the dS products take P and dS as two
    bf16 products, f32 to ~2^-17), and the kernels round their outputs to
    bf16 (2^-8 relative each); f32: summation order and expf only. K2's delta: f32
    sums in another order, 1e-5 of max(1, |delta|)."""
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
        dq, dq_delta = flash_attention_dq(q, k, v, dout, ref_lse, ref_out32,
                                          causal, None, block_q, block_k)
        dk, dv = flash_attention_dkv(q, k, v, dout, ref_lse, delta, causal,
                                     None, block_q, block_k)
        torch.cuda.synchronize()
        assert _rel_err(dq_delta, delta) <= 1e-5, where
        assert (flash_attention_lse.launches, flash_attention_dq.launches,
                flash_attention_dkv.launches) == tuple(c + 1 for c in counts)
        out_tol = 1e-2 if dt == torch.bfloat16 else 1e-5
        assert float((out.float() - ref_out.float()).abs().max()) <= \
            out_tol, where
        # the f32 output: the kernel's P V is two bf16 products (P rounded
        # and its remainder), the plain version's one f32 product
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


@pytest.mark.cuda
def test_cuda_training_kernels_keep_small_gradients():
    """Near-uniform attention over keys and queries that share a large
    common component (|c| ~ 2 per dim, spread 0.05), as at BERT-base's
    initialization: dS = P o (dP - delta) is a small difference, and dQ =
    dS K and dK = dS^T Q cancel the component. The training forward's P V
    (delta's source) and K2/K3's dS products take P and dS as two bf16
    products (rounded and remainder), so bf16 autograd's dq and dk land
    within 2.5e-3 of exact attention of the same bf16 inputs, relative L2:
    the bf16 gradients' own rounding is 1.7e-3 (the CPU's plain path, f32
    inside, lands there), a CPU emulation of the kernels adds 1.3e-4
    before it, and with P and dS rounded to bf16 once 8.8e-2. dv, from P
    rounded as in plain attention, within 5e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(29)
    b, h, s, dh = 4, 12, 128, 64
    common = 2 * rng.standard_normal((1, h, 1, dh))
    q, k = (common + 0.05 * rng.standard_normal((b, h, s, dh))
            for _ in range(2))
    v, dout = (rng.standard_normal((b, h, s, dh)) for _ in range(2))
    q, k, v, dout = (torch.from_numpy(t.astype(np.float32)).to(
        torch.bfloat16) for t in (q, k, v, dout))
    qd, kd, vd, dod = (t.double() for t in (q, k, v, dout))
    p = torch.softmax(qd @ kd.transpose(-1, -2) / dh ** 0.5, -1)
    dp = dod @ vd.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) / dh ** 0.5
    exact = (ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod)
    leaves = [t.to("cuda").requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves).backward(dout.to("cuda"))
    errs = [float((t.grad.double().cpu() - e).norm() / e.norm())
            for t, e in zip(leaves, exact)]
    assert errs[0] <= 2.5e-3 and errs[1] <= 2.5e-3 and errs[2] <= 5e-3, errs


def _projection_views(seed, fused, b, h, s, dh):
    """bf16 q, k, v on the card as ``multi_head_attention`` hands them to
    K1: (B, H, S, Dh) views of the projection einsum's (B, S, H, Dh) (or,
    fused, (B, S, 3, H, Dh)) output, unit variance."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h * dh)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, h * dh, h, dh))
                          / np.sqrt(h * dh)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    if fused:
        return tuple(torch.einsum("bsd,tdhk->tbhsk", x, w))
    return tuple(torch.einsum("bsd,dhk->bhsk", x, w[i]) for i in range(3))


@pytest.mark.cuda
def test_cuda_k1_at_the_vit_shape():
    """K1 (serving) and K1-LSE (training) at ViT-B/16's attention shape,
    B=64, H=12, S=196, Dh=64 bf16, against their plain versions; each call
    advances its own launch counter by exactly one. Serving takes P V in
    one product of P rounded to bf16, training in two (P rounded and its
    remainder): its f32 output is the plain f32 output to f32's accuracy
    (1e-4 here; a CPU emulation of the split lands 1.6e-6 from exact), and
    its bf16 output that output rounded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.to("cuda", torch.bfloat16)
               for t in _qkv(17, b=64, h=12, sq=196))
    counts = (flash_attention.launches, flash_attention_lse.launches)
    with torch.inference_mode():
        out = flash_attention(q, k, v)
    out_l, lse, out32 = flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_lse.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref, ref_lse, ref32 = flash_attention_plain(q, k, v, return_lse=True)
    assert torch.equal(out_l, out32.to(torch.bfloat16))
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2
    assert float((out_l.float() - ref.float()).abs().max()) <= 1e-2
    assert float((out32 - ref32).abs().max()) <= 1e-4
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    assert lse.shape == (64 * 12, 196) and bool(torch.isfinite(lse).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_k1_reads_projection_views(fused, dh):
    """K1 and K1-LSE read the projection's strided views through their
    tensor maps: the same bits as on contiguous copies, within tolerance of
    the plain version, and the output keeps q's memory order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _projection_views(18, fused, b=3, h=4, s=196, dh=dh)
    assert not q.is_contiguous()
    copies = [t.contiguous() for t in (q, k, v)]
    before = flash_attention.launches
    with torch.inference_mode():
        out = flash_attention(q, k, v)
        out_c = flash_attention(*copies)
    got = flash_attention_lse(q, k, v)
    got_c = flash_attention_lse(*copies)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, out_c)
    assert all(torch.equal(a, b) for a, b in zip(got, got_c))
    assert out.stride() == torch.empty_like(q).stride()
    ref = flash_attention_plain(*copies)
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_k2_k3_read_projection_views(fused, dh):
    """K2 and K3 read the projection's strided views of q, k, v and a
    strided dO through their tensor maps: the same bits as on contiguous
    copies, within tolerance of the plain versions (as
    test_cuda_training_kernels_match_plain), and the gradients keep their
    inputs' memory order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _projection_views(21, fused, b=3, h=4, s=196, dh=dh)
    dout = _projection_views(22, False, b=3, h=4, s=196, dh=dh)[0]
    assert not any(t.is_contiguous() for t in (q, k, v, dout))
    copies = [t.contiguous() for t in (q, k, v, dout)]
    _, lse, out32 = flash_attention_plain(*copies[:3], return_lse=True)
    delta = flash_mod._delta(out32, copies[3])
    counts = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq, dq_delta = flash_attention_dq(q, k, v, dout, lse, out32)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta)
    dq_c, dq_delta_c = flash_attention_dq(*copies, lse, out32)
    dk_c, dv_c = flash_attention_dkv(*copies, lse, delta)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        counts[0] + 2, counts[1] + 2)
    ref_dq = flash_attention_dq_plain(*copies, lse, delta)
    ref_dk, ref_dv = flash_attention_dkv_plain(*copies, lse, delta)
    for name, got, same, ref, like in (("dq", dq, dq_c, ref_dq, q),
                                       ("dk", dk, dk_c, ref_dk, k),
                                       ("dv", dv, dv_c, ref_dv, v)):
        assert torch.equal(got, same), name
        assert got.stride() == torch.empty_like(like).stride(), name
        assert _rel_err(got, ref) <= 1e-2, (name, _rel_err(got, ref))
    assert torch.equal(dq_delta, dq_delta_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_k2_takes_delta(dh):
    """bf16 K2 takes delta = rowsum(dO o O) in the kernel from the
    forward's f32 output: within 1e-5 of PyTorch's (relative to max(1,
    max |delta|): f32 sums in another order) and exactly 0 on dead rows,
    with dq within tolerance of the plain version, on the shapes above,
    in one launch. f32 K2 returns PyTorch's delta itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for shape, causal in SHAPES:
        q, k, v = (t.to("cuda", torch.bfloat16)
                   for t in _qkv(24, dh=dh, **shape))
        dout = _qkv(25, dh=dh, **shape)[0].to("cuda", torch.bfloat16)
        _, lse, out32 = flash_attention_plain(q, k, v, causal,
                                              return_lse=True)
        delta = flash_mod._delta(out32, dout)
        before = flash_attention_dq.launches
        dq, got = flash_attention_dq(q, k, v, dout, lse, out32, causal)
        torch.cuda.synchronize()
        assert flash_attention_dq.launches == before + 1
        assert got.shape == delta.shape and got.dtype == torch.float32
        assert _rel_err(got, delta) <= 1e-5, (shape, causal)
        ref = flash_attention_dq_plain(q, k, v, dout, lse, delta, causal)
        assert _rel_err(dq, ref) <= 1e-2, (shape, causal)
        sq, skv = q.shape[2], k.shape[2]
        if causal and sq > skv:
            assert float(got.view(q.shape[:3])[:, :, :sq - skv].abs().max()
                         ) == 0.0
            assert float(dq[:, :, :sq - skv].abs().max()) == 0.0
    q, k, v, dout = (t.float() for t in (q, k, v, dout))
    _, lse, out = flash_attention_plain(q, k, v, return_lse=True)
    _, delta = flash_attention_dq(q, k, v, dout, lse, out)
    assert torch.equal(delta, flash_mod._delta(out, dout))


@pytest.mark.cuda
def test_cuda_bwd_refused_launch_raises(monkeypatch):
    """With the Python checks bypassed, what K2's and K3's C entries refuse
    (a tensor map cuTensorMapEncodeTiled refuses, bf16 inputs without
    strides) raises from the wrappers and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.to("cuda", torch.bfloat16)
               for t in _qkv(23, b=1, h=2, sq=40))
    _, lse, out32 = flash_attention_plain(q, k, v, return_lse=True)
    delta = flash_mod._delta(out32, q)
    monkeypatch.setattr(
        flash_mod, "_check_kernel_args", lambda q, k, v, *args, **kwargs: [
            flash_mod._view_strides(t) for t in (q, k, v, args[2])])
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    # rows 136 bytes apart: TMA takes strides in multiples of 16 bytes
    padded = [torch.nn.functional.pad(t, (0, 4))[..., :64]
              for t in (q, k, v, q)]
    with pytest.raises(RuntimeError, match="tensor map"):
        flash_attention_dq(*padded, lse, out32)
    with pytest.raises(RuntimeError, match="tensor map"):
        flash_attention_dkv(*padded, lse, delta)
    monkeypatch.setattr(flash_mod, "_check_kernel_args",
                        lambda *args, **kwargs: [])
    with pytest.raises(RuntimeError, match="strides"):
        flash_attention_dq(q, k, v, q, lse, out32)
    with pytest.raises(RuntimeError, match="strides"):
        flash_attention_dkv(q, k, v, q, lse, delta)
    assert (flash_attention_dq.launches,
            flash_attention_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_k1_large_batch_causal(dh):
    """K1-LSE at a batch of many blocks: causal S=196, causal Sq<Skv, and
    dead rows, every head dim. A row that sees few keys has outputs up to
    ~3, where one bf16 rounding of the output is 2^-8 of it: the
    tolerance is 1e-2 of max(1, |ref|) per element (the f32 output and
    the LSE as in the tests above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for sq, skv in ((196, 196), (64, 196), (196, 64)):
        q, k, v = (t.to("cuda", torch.bfloat16)
                   for t in _qkv(19, b=16, h=12, sq=sq, skv=skv, dh=dh))
        out, lse, out32 = flash_attention_lse(q, k, v, True)
        ref, ref_lse, ref32 = flash_attention_plain(q, k, v, True,
                                                    return_lse=True)
        torch.cuda.synchronize()
        rel = (out.float() - ref.float()).abs() / ref.float().abs().clamp(
            min=1.0)
        assert float(rel.max()) <= 1e-2, (sq, skv)
        assert float((out32 - ref32).abs().max()) <= 1e-2, (sq, skv)
        live = torch.isfinite(ref_lse)
        assert torch.equal(torch.isfinite(lse), live), (sq, skv)
        assert float((lse[live] - ref_lse[live]).abs().max()) <= 1e-3
        if sq > skv:
            assert float(out[:, :, :sq - skv].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_refused_launch_raises(monkeypatch):
    """With the Python checks bypassed, what the C entry refuses (a tensor
    map cuTensorMapEncodeTiled refuses, a head dim without a body, missing
    strides) raises from the wrapper, returns no output and counts no
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.to("cuda", torch.bfloat16)
               for t in _qkv(20, b=1, h=2, sq=40))
    # the checks pass everything on, with the strides the C entry reads
    monkeypatch.setattr(
        flash_mod, "_check_kernel_args", lambda q, k, v, *args, **kwargs: [
            flash_mod._view_strides(t) for t in (q, k, v)])
    before = flash_attention.launches
    # rows 136 bytes apart: TMA takes strides in multiples of 16 bytes
    padded = [torch.nn.functional.pad(t, (0, 4))[..., :64] for t in (q, k, v)]
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="tensor map"):
            flash_attention(*padded)
        with pytest.raises(RuntimeError, match="head dim"):
            flash_attention(q[..., :24], k[..., :24], v[..., :24])
        # and bf16 inputs whose strides never reach it
        monkeypatch.setattr(flash_mod, "_check_kernel_args",
                            lambda *args, **kwargs: [])
        with pytest.raises(RuntimeError, match="strides"):
            flash_attention(q, k, v)
    assert flash_attention.launches == before


#: the TorchViT template at test width (the architecture knobs narrowed)
_NARROW_EDITS = [
    ("class TorchViT(BaseModel):", "class NarrowViT(BaseModel):"),
    ('"image_size": FixedKnob(224)', '"image_size": FixedKnob(32)'),
    ('"patch_size": FixedKnob(16)', '"patch_size": FixedKnob(4)'),
    ('"dim": FixedKnob(768)', '"dim": FixedKnob(128)'),
    ('"depth": FixedKnob(12)', '"depth": FixedKnob(2)'),
    ('"heads": FixedKnob(12)', '"heads": FixedKnob(2)'),
    ('"num_classes": FixedKnob(1000)', '"num_classes": FixedKnob(10)'),
    ('"batch_size": CategoricalKnob([64, 128])',
     '"batch_size": CategoricalKnob([16, 32])'),
]


@pytest.mark.cuda
def test_cuda_client_admin_cycle(tmp_path):
    """On the card, through the port's Client -> AdminServer -> Admin with
    its default placement (the visible CUDA devices): a 2-trial train job
    of a narrow ViT granted cuda:0, whose steps launch K1-LSE, K2 and K3,
    then an inference job whose answers (K1 in every forward) agree with
    the plain-attention ensemble of the downloaded trials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pathlib import Path

    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.models.transformer import TransformerConfig
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.sdk.params import load_params

    torch.backends.cuda.matmul.allow_tf32 = False
    source = (Path(flash_mod.__file__).parents[1] / "templates"
              / "torch_vit.py").read_text()
    for old, new in _NARROW_EDITS:
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    rng = np.random.default_rng(0)
    patterns = rng.random((10, 32, 32, 3), dtype=np.float32)
    uris = []
    for name, n in (("train", 128), ("test", 32)):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = 0.6 * patterns[y] + 0.4 * rng.random((n, 32, 32, 3),
                                                 dtype=np.float32)
        uris.append(write_numpy_dataset(x, y, str(tmp_path / f"{name}.npz")))
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  params_dir=str(tmp_path / "params"))
    server = AdminServer(admin).start()
    kernels = (flash_attention_lse, flash_attention_dq, flash_attention_dkv)
    try:
        c = Client("127.0.0.1", server.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("narrow", "IMAGE_CLASSIFICATION", source.encode(),
                       "NarrowViT")
        before = [k.launches for k in kernels]
        c.create_train_job("narrow", "IMAGE_CLASSIFICATION", *uris,
                           budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("narrow", timeout_s=300)
        assert job["status"] == "STOPPED"
        assert [w["chips"] for w in job["workers"]] == [[0]]
        trials = c.get_trials_of_train_job("narrow")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2
        steps = sum(128 // t["knobs"]["batch_size"] for t in trials)
        assert [k.launches - b for k, b in zip(kernels, before)] == [
            2 * steps] * 3
        trees = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        c.create_inference_job("narrow")
        with np.load(uris[1]) as z:
            images = z["x"][:8]
        k1 = flash_attention.launches
        probs = np.asarray(c.predict("narrow", images.tolist()))
        assert flash_attention.launches > k1
        c.stop_inference_job("narrow")
    finally:
        server.stop()
        admin.shutdown()
    cfg = vit.ViTConfig(image_size=32, patch_size=4, num_classes=10,
                        encoder=TransformerConfig(dim=128, depth=2, heads=2,
                                                  use_flash=False))
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        ref = sum(torch.softmax(convert.from_jax_params(t, cfg, "cuda:0")(x),
                                -1).double().cpu().numpy()
                  for t in trees) / 2
    assert probs.shape == (8, 10) and np.isfinite(probs).all()
    assert float(np.abs(probs - ref).max()) <= 1e-3


@pytest.mark.cuda
def test_cuda_process_placement_cycle(tmp_path, monkeypatch):
    """On the card, under RAFIKI_PLACEMENT=process: a 2-trial narrow-ViT
    job in a train child (granted the card through CUDA_VISIBLE_DEVICES),
    then two serving children over the shm rings. Each child's exit line
    reports its kernel launches: K1 in every child, and K1-LSE, K2 and K3
    in the train child, 2 a step (2 blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import re
    from pathlib import Path

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset

    monkeypatch.setenv("RAFIKI_PLACEMENT", "process")
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("RAFIKI_SHM_RING_BYTES", str(4 << 20))
    source = (Path(flash_mod.__file__).parents[1] / "templates"
              / "torch_vit.py").read_text()
    for old, new in _NARROW_EDITS:
        source = source.replace(old, new)
    rng = np.random.default_rng(0)
    uris = []
    for name, n in (("train", 64), ("test", 16)):
        x = rng.random((n, 32, 32, 3), dtype=np.float32)
        y = rng.integers(0, 10, n).astype(np.int32)
        uris.append(write_numpy_dataset(x, y, str(tmp_path / f"{name}.npz")))
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  params_dir=str(tmp_path / "params"))
    assert isinstance(admin.placement, ProcessPlacementManager)
    server = AdminServer(admin).start()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("narrow", "IMAGE_CLASSIFICATION", source.encode(),
                       "NarrowViT")
        c.create_train_job("narrow", "IMAGE_CLASSIFICATION", *uris,
                           budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("narrow", timeout_s=300)
        assert job["status"] == "STOPPED"
        trials = c.get_trials_of_train_job("narrow")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2
        steps = sum(64 // t["knobs"]["batch_size"] for t in trials)
        c.create_inference_job("narrow")
        with np.load(uris[1]) as z:
            probs = np.asarray(c.predict("narrow", z["x"][:8].tolist()))
        assert probs.shape == (8, 10) and np.isfinite(probs).all()
        c.stop_inference_job("narrow")
    finally:
        server.stop()
        admin.shutdown()
    by_service = {}
    for path in (tmp_path / "logs").glob("service-*.log"):
        lines = re.findall(r"kernel launches \(pid \d+\): (\{.*\})",
                           path.read_text())
        assert len(lines) == 1, path
        by_service[path.stem[len("service-"):]] = json.loads(lines[0])
    train = by_service.pop(job["workers"][0]["service_id"])
    assert train["flash_attention"] == 2 * 2  # an evaluate a trial
    assert [train[k] for k in ("flash_attention_lse", "flash_attention_dq",
                               "flash_attention_dkv")] == [2 * steps] * 3
    assert len(by_service) == 2
    assert all(v["flash_attention"] > 0 and v["flash_attention_lse"] == 0
               for v in by_service.values())


# ---------------------------------------------------------------------------
# the image-classification zoo: ResNet on the card against the CPU path
# ---------------------------------------------------------------------------

def _resnet(bottleneck, device, train=False):
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig(stage_sizes=(1, 1), bottleneck=bottleneck,
                              width=16, num_classes=10, small_inputs=True)
    with torch.device("meta"):
        model = resnet.ResNet(cfg)
    return from_jax_tree(model, *resnet.init(np.random.default_rng(0), cfg),
                         device, train)


@pytest.mark.cuda
@pytest.mark.parametrize("bottleneck", [True, False])
def test_cuda_resnet_forward_matches_cpu(bottleneck):
    """Training and evaluation forwards on cuda:0 (cuDNN convolutions in
    channels_last) against the CPU path on the same tree and images: bf16
    logits a few ulps apart (2e-2 of the logits' scale: one ulp of a
    logit in [4, 8) is 2^-5), running statistics within 1e-3 of each
    vector's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 32, 32, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda:0"):
        model = _resnet(bottleneck, dev)
        with torch.no_grad():
            logits, new = model(x.to(dev), train=True)
            evals, _ = model(x.to(dev), new, train=False)
        out[dev] = (logits.cpu(), {k: v.cpu() for k, v in new.items()},
                    evals.cpu())
    (l_cpu, s_cpu, e_cpu), (l_gpu, s_gpu, e_gpu) = out["cpu"], out["cuda:0"]
    for got, ref in ((l_gpu, l_cpu), (e_gpu, e_cpu)):
        assert float((got - ref).abs().max()) <= 2e-2 * max(
            1.0, float(ref.abs().max()))
    for k, ref in s_cpu.items():
        assert float((s_gpu[k] - ref).abs().max()) <= 1e-3 * max(
            1.0, float(ref.abs().max())), k


@pytest.mark.cuda
def test_cuda_resnet_train_step_matches_cpu():
    """One stateful AdamW step on cuda:0 and on the CPU from the same
    tree and batch: the loss within 1e-2; each parameter's gradient
    within 5e-2 of its L2 norm (bar the convolution biases, which feed a
    BatchNorm: their gradient is zero but for rounding); the running
    statistics within 1e-3 of each vector's scale. (Not the updates: an
    AdamW first step moves each weight by about lr times the sign of its
    gradient, so a gradient near zero that rounding turns around moves
    it by 2 lr.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        tunable_optimizer,
    )
    from rafiki_tpu_torch.templates import torch_resnet

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((32, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 32))
    out = {}
    for dev in ("cpu", "cuda:0"):
        model = _resnet(True, dev, train=True)
        trainer = DataParallelTrainer(
            torch_resnet._loss, tunable_optimizer(
                torch.optim.AdamW, lr=1e-3, weight_decay=1e-4),
            device=dev, stateful=True)
        state = model.state()
        opt = trainer.optimizer(model.parameters())
        loss = trainer.train_step(model, opt, (x.to(dev), y.to(dev)), state)
        # the step leaves this step's gradients in place
        out[dev] = (float(loss), {k: v.grad.double().cpu()
                                  for k, v in model.named_parameters()},
                    {k: v.cpu() for k, v in state.items()})
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda:0"]
    assert abs(l_gpu - l_cpu) <= 1e-2
    for k, ref in g_cpu.items():
        if k.endswith(("conv1.bias", "conv2.bias", "conv3.bias",
                       "proj.bias", "stem.bias")):
            continue
        assert float((g_gpu[k] - ref).norm()) <= 5e-2 * float(ref.norm()), k
    for k, ref in s_cpu.items():
        assert float((s_gpu[k] - ref).abs().max()) <= 1e-3 * max(
            1.0, float(ref.abs().max())), k


@pytest.mark.cuda
def test_cuda_causal_training_kernels_at_the_lm_shape():
    """K1-LSE, K2 and K3 causal at the LM's training shape (B=8, H=12,
    S=512, Dh=64, bf16) against their plain versions: the LSE within
    1e-3, each gradient within 1e-2 of max(1, |ref|) (phase 2's
    tolerances), the outputs within 1e-2 of max(1, |ref|) per element, as
    in test_cuda_k1_large_batch_causal (the first rows see a key or two
    and output values of ~|v|, up to ~4.5 here, where one bf16 ulp is
    2^-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.to("cuda", torch.bfloat16)
               for t in _qkv(21, b=8, h=12, sq=512))
    dout = torch.from_numpy(np.random.default_rng(22).standard_normal(
        q.shape).astype(np.float32)).to("cuda", torch.bfloat16)
    out, lse, out32 = flash_attention_lse(q, k, v, True)
    ref, ref_lse, ref32 = flash_attention_plain(q, k, v, True,
                                                return_lse=True)
    delta = flash_mod._delta(ref32, dout)
    dq, _ = flash_attention_dq(q, k, v, dout, ref_lse, ref32, True)
    dk, dv = flash_attention_dkv(q, k, v, dout, ref_lse, delta, True)
    ref_dq = flash_attention_dq_plain(q, k, v, dout, ref_lse, delta, True)
    ref_dk, ref_dv = flash_attention_dkv_plain(q, k, v, dout, ref_lse,
                                               delta, True)
    torch.cuda.synchronize()
    for got, want in ((out, ref), (out32, ref32)):
        rel = (got.float() - want.float()).abs() / want.float().abs().clamp(
            min=1.0)
        assert float(rel.max()) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_cuda_head_dim_outside_the_kernels_raises_typed():
    """A head dim the kernels are not built for (8: the tiny generation
    fixture's 16 wide over 2 heads) raises typed on the card, never falls
    back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.to("cuda", torch.bfloat16)
               for t in _qkv(23, b=1, h=2, sq=16, dh=8))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim 8"):
        flash_attention(q, k, v, True)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_cuda_bert_base_forward_matches_cpu():
    """BERT-base (depth cut to 2) on cuda:0, K1, against the CPU's plain
    attention on the same tree: logits within 5e-2 of max(1, |ref|) (bf16
    through two blocks, the two attentions rounding at other places)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import bert

    cfg = bert.bert_base()
    cfg = dataclasses.replace(cfg, max_len=128, encoder=dataclasses.replace(
        cfg.encoder, depth=2))
    tree = bert.init(np.random.default_rng(0), cfg)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (16, 128)))
    launches = flash_attention.launches
    with torch.inference_mode():
        gpu = convert.from_jax_params(tree, cfg, "cuda:0")(ids.cuda())
        cpu = convert.from_jax_params(tree, cfg, "cpu")(ids)
    assert flash_attention.launches - launches == 2
    assert float((gpu.cpu() - cpu).abs().max()) <= 5e-2 * max(
        1.0, float(cpu.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_greedy_decode_round_matches_cpu(paged):
    """One prefill and greedy decode round of a 2-block, 768-wide LM on
    cuda:0 against the CPU (both f32): the logits within 1e-3 of max(1,
    |ref|), and no attention kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lm.tiny(vocab=32000, max_len=256, dim=768, depth=2, heads=12)
    tree = lm.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (40, 100)]
    tables = np.arange(32, dtype=np.int32).reshape(2, 16)
    counts = [f.launches for f in (flash_attention, flash_attention_lse)]
    out = {}
    for dev in ("cpu", "cuda:0"):
        model = convert.from_jax_params(tree, cfg, dev)
        if paged:
            cache = lm.init_paged_kv_cache(cfg, 32, 16, device=dev)
            firsts = [lm.paged_prefill(model, cache, tables[i], p, 0,
                                       len(p))[0] for i, p in
                      enumerate(prompts)]
        else:
            cache = lm.init_kv_cache(cfg, 2, 256, device=dev)
            firsts = [lm.prefill(model, cache, i, p, len(p))[0]
                      for i, p in enumerate(prompts)]
        ids = np.array([int(f.argmax()) for f in firsts])
        pos = np.array([len(p) for p in prompts])
        if paged:
            logits, _ = lm.paged_decode_step(model, cache, ids, pos, tables)
        else:
            logits, _ = lm.decode_step(model, cache, ids, pos)
        out[dev] = (torch.stack(firsts).cpu(), logits.cpu())
    for got, ref in zip(out["cuda:0"], out["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-3 * max(
            1.0, float(ref.abs().max()))
    assert [f.launches for f in (flash_attention,
                                 flash_attention_lse)] == counts
