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
@pytest.mark.parametrize("dh", flash_mod.HEAD_DIMS)
def test_cuda_vmapped_k1_is_one_launch_over_every_trial(dh):
    """K1 under ``torch.func.vmap`` over T stacked trials' projections
    (a fused ensemble's forward): ONE launch a call over all T·B rows,
    each trial's output the same bits as K1 on that trial alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, b, h, s = 3, 4, 2, 130
    gen = torch.Generator(device="cuda").manual_seed(dh)
    x = torch.randn(t, b, s, h * dh, generator=gen,
                    device="cuda").to(torch.bfloat16)
    ws = [(torch.randn(t, h * dh, h, dh, generator=gen, device="cuda")
           * 0.05).to(torch.bfloat16) for _ in range(3)]

    def project(xt, wq, wk, wv):
        return [torch.einsum("bsd,dhk->bhsk", xt, w) for w in (wq, wk, wv)]

    with torch.inference_mode():
        q, k, v = torch.func.vmap(project)(x, *ws)
        before = flash_attention.launches
        out = torch.func.vmap(flash_attention)(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        for i in range(t):
            alone = flash_attention(q[i], k[i], v[i])
            assert torch.equal(out[i], alone)
            ref = flash_attention_plain(q[i], k[i], v[i]).float()
            # an output of a few units rounds by 2^-7 of it in bf16: the
            # error over max(1, |ref|), as the large-batch causal test
            # holds it
            err = (out[i].float() - ref).abs() / ref.abs().clamp(min=1.0)
            assert float(err.max()) <= 1e-2


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


@pytest.mark.cuda
def test_cuda_host_agent_cycle(tmp_path, monkeypatch):
    """On the card, under host placement: an agent process (``python -m
    rafiki_tpu_torch.placement.agent`` on card 0) takes a narrow-ViT
    train child, whose steps launch K1-LSE, K2 and K3 (2 a step), and a
    serving child reached through ``/predict_relay`` in binary frames,
    whose answers (K1 in every forward) agree with the downloaded trial's
    own forward in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import os
    import re
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.agent import READY_PREFIX
    from rafiki_tpu_torch.placement.hosts import HostAgentPlacementManager
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.utils.agent_http import call_agent

    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(flash_mod.__file__).parents[2]
    logs = tmp_path / "logs"
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(logs))
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    source = (root / "rafiki_tpu_torch" / "templates" / "torch_vit.py"
              ).read_text()
    for old, new in _NARROW_EDITS:
        source = source.replace(old, new)
    rng = np.random.default_rng(0)
    uris = []
    for name, n in (("train", 64), ("test", 16)):
        x = rng.random((n, 32, 32, 3), dtype=np.float32)
        y = rng.integers(0, 10, n).astype(np.int32)
        uris.append(write_numpy_dataset(x, y, str(tmp_path / f"{name}.npz")))
    store = str(tmp_path / "store.sqlite3")
    db = Database(store)
    with socket.socket() as s:  # a free port for the admin's door
        s.bind(("127.0.0.1", 0))
        admin_port = s.getsockname()[1]
    env = {**os.environ, "RAFIKI_AGENT_CHIPS": "0", "RAFIKI_AGENT_KEY": "k",
           "RAFIKI_DB_PATH": store, "RAFIKI_WORKDIR": str(tmp_path),
           "RAFIKI_LOGS_DIR": str(logs),
           "RAFIKI_SHM_RING_BYTES": str(4 << 20),
           "RAFIKI_ADMIN_ADDR": f"127.0.0.1:{admin_port}",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(root), os.environ.get("PYTHONPATH")) if p)}
    agent = subprocess.Popen(
        [sys.executable, "-m", "rafiki_tpu_torch.placement.agent"], env=env,
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    line = agent.stdout.readline()
    assert line.startswith(READY_PREFIX), line
    addr = line[len(READY_PREFIX):].split()[0]
    placement = HostAgentPlacementManager([addr], key="k", db=db,
                                          heartbeat_interval_s=0)
    admin = Admin(db=db, placement=placement,
                  params_dir=str(tmp_path / "params"))
    server = AdminServer(admin, port=admin_port).start()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("narrow", "IMAGE_CLASSIFICATION", source.encode(),
                       "NarrowViT")
        c.create_train_job("narrow", "IMAGE_CLASSIFICATION", *uris,
                           budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("narrow", timeout_s=300)
        assert job["status"] == "STOPPED"
        (trial,) = c.get_trials_of_train_job("narrow")
        assert trial["status"] == "COMPLETED"
        steps = 64 // trial["knobs"]["batch_size"]
        tree = load_params(c.download_trial_params(trial["id"]))
        inf = c.create_inference_job("narrow")
        (replica,) = [w["service_id"] for w in inf["workers"]]
        assert replica in placement.placements()  # on the agent
        with np.load(uris[1]) as z:
            images = z["x"][:8]
        probs = np.asarray(c.predict("narrow", images.tolist()))
        relays = call_agent(addr, "GET", "/inventory", key="k",
                            timeout_s=30)["relays"]
        assert relays["binary"] >= 1 and relays["json"] == 0
        c.stop_inference_job("narrow")
    finally:
        server.stop()
        admin.shutdown()
        agent.terminate()
        assert agent.wait(timeout=120) == 0
    deadline = time.monotonic() + 60
    by_service = {}
    while time.monotonic() < deadline and len(by_service) < 2:
        by_service = {}
        for path in logs.glob("service-*.log"):
            found = re.findall(r"kernel launches \(pid \d+\): (\{.*\})",
                               path.read_text())
            if found:
                by_service[path.stem[len("service-"):]] = json.loads(
                    found[0])
        time.sleep(0.2)
    train = by_service.pop(job["workers"][0]["service_id"])
    assert train["flash_attention"] == 2  # one evaluate
    assert [train[k] for k in ("flash_attention_lse", "flash_attention_dq",
                               "flash_attention_dkv")] == [2 * steps] * 3
    assert list(by_service) == [replica]
    assert by_service[replica]["flash_attention"] > 0
    assert by_service[replica]["flash_attention_lse"] == 0
    # the same trial's forward in this process: its template, the kernels
    model = load_model_class(source.encode(), "NarrowViT")(**trial["knobs"])
    model.load_parameters(tree)
    ref = np.asarray(model.predict(images))
    model.destroy()
    assert probs.shape == (8, 10) and np.isfinite(probs).all()
    assert float(np.abs(probs - ref).max()) <= 1e-3


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


#: a verify's decision is compared where it lies at least this far from
#: where it would flip (as chip_smoke.py's DRAW_MARGIN and TIE_GAP)
DRAW_MARGIN, TIE_GAP = 1e-5, 1e-4


def _spec_lms():
    """A 2-block, 768-wide target LM and a 2-block, 384-wide draft (6
    heads, Dh 64) on the same vocabulary, seeded."""
    from rafiki_tpu_torch.models import lm

    cfg = lm.tiny(vocab=32000, max_len=256, dim=768, depth=2, heads=12)
    dcfg = lm.tiny(vocab=32000, max_len=256, dim=384, depth=2, heads=6)
    return (cfg, lm.init(np.random.default_rng(0), cfg), dcfg,
            lm.init(np.random.default_rng(1), dcfg))


def _sampling(temps, role, n):
    return {"seed": np.arange(1, n + 1, dtype=np.uint32),
            "temperature": np.asarray(temps, np.float32),
            "top_k": np.zeros(n, np.int32),
            "top_p": np.full(n, 0.95, np.float32), "role": role}


def _verify_margins(logits, ids, positions, q, sampling):
    """Each row's least distance of a verify decision from its flip: a
    greedy row's top-2 gaps where it committed; a sampled row's accept
    tests up to its first rejection and its last draw's uniform from the
    cumulative boundaries (the CPU's f32 numbers)."""
    from rafiki_tpu_torch.models import lm

    k = ids.shape[1] - 1
    d = torch.from_numpy(ids[:, 1:].astype(np.int64))
    temp = np.asarray(sampling["temperature"], np.float32)
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    p = lm.modified_dist(logits, temp[:, None],
                         np.asarray(sampling["top_k"])[:, None],
                         np.asarray(sampling["top_p"])[:, None])
    p_d = torch.gather(p[:, :k], -1, d[..., None])[..., 0]
    q_d = torch.gather(q, -1, d[..., None])[..., 0]
    u = torch.from_numpy(lm._uniform_at(sampling["seed"], positions[:, 1:],
                                        lm.ROLE_ACCEPT))
    a = torch.cumprod((u * q_d < p_d).long(), -1).sum(-1)
    test = (u * q_d - p_d).abs().numpy()
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rs = resid.sum(-1, keepdim=True)
    dist = torch.cat([torch.where(rs > 1e-20, resid / rs.clamp_min(1e-20),
                                  p[:, :k]), p[:, k:]], 1)
    x = dist[torch.arange(len(a)), a]
    u_x = torch.from_numpy(lm._uniform_at(
        sampling["seed"], positions[:, 0] + 1 + a.numpy(), lm.ROLE_TARGET))
    draw = (x.cumsum(-1) - u_x[:, None]).abs().min(-1).values.numpy()
    return np.asarray([
        gap[i, :ai + 1].min() if temp[i] <= 0
        else min(test[i, :min(ai + 1, k)].min(), draw[i])
        for i, ai in enumerate(a.tolist())])


@pytest.mark.cuda
def test_cuda_verify_step_matches_cpu():
    """``paged_verify_step`` on cuda:0 against the same call on a CPU
    copy (f32): 4 slots at k=4, one greedy and three sampled (at low
    temperatures), proposals and q from a draft's burst on the CPU. Accept lengths and tokens
    equal on every row whose decisions clear DRAW_MARGIN (a greedy row
    TIE_GAP); the rows written within 1e-3 of max(1, |ref|); no attention
    kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree, dcfg, dtree = _spec_lms()
    s, k, bt = 4, 4, 16
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (40, 100, 61, 17)]
    tables = np.arange(s * 16, dtype=np.int32).reshape(s, 16)
    n = np.asarray([len(p) for p in prompts])
    # low temperatures: a seeded model's distribution over 32,000 tokens
    # is near flat, its cumulative boundaries closer than DRAW_MARGIN
    temps = [0.0, 0.1, 0.15, 0.1]
    draft = convert.from_jax_params(dtree, dcfg, "cpu")
    ring = lm.init_kv_cache(dcfg, s, 256)
    firsts = [int(lm.prefill(draft, ring, i, p, len(p))[0].argmax())
              for i, p in enumerate(prompts)]
    d_ids, q, _ = lm.decode_steps_sampled(
        draft, ring, firsts, n, k, _sampling(temps, lm.ROLE_DRAFT, s))
    ids = np.concatenate([np.asarray(firsts)[:, None], d_ids.numpy()], 1)
    pos = n[:, None] + np.arange(k + 1)
    vsamp = _sampling(temps, lm.ROLE_TARGET, s)
    counts = [f.launches for f in (flash_attention, flash_attention_lse)]
    out = {}
    for dev in ("cpu", "cuda:0"):
        model = convert.from_jax_params(tree, cfg, dev)
        cache = lm.init_paged_kv_cache(cfg, s * 16, bt, device=dev)
        for i, p in enumerate(prompts):
            lm.paged_prefill(model, cache, tables[i], p, 0, len(p))
        if dev == "cpu":
            with torch.inference_mode():
                view = {kk: v.clone() for kk, v in cache.items()}
                logits = lm._paged_forward(model, view, tables, ids, pos)
        acc, toks, cache = lm.paged_verify_step(
            model, cache, ids, pos, tables, q.to(dev), vsamp)
        out[dev] = (acc.cpu(), toks.cpu(), cache["k"].cpu())
    margins = _verify_margins(logits, ids, pos, q, vsamp)
    compared = 0
    for i in range(s):
        if margins[i] < (TIE_GAP if temps[i] <= 0 else DRAW_MARGIN):
            continue
        compared += 1
        assert int(out["cuda:0"][0][i]) == int(out["cpu"][0][i])
        assert out["cuda:0"][1][i].tolist() == out["cpu"][1][i].tolist()
    assert compared >= 3, margins
    ref = out["cpu"][2]
    assert float((out["cuda:0"][2] - ref).abs().max()) <= 1e-3 * max(
        1.0, float(ref.abs().max()))
    assert [f.launches for f in (flash_attention,
                                 flash_attention_lse)] == counts


@pytest.mark.cuda
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_cuda_draft_burst_equals_its_chained_steps(temp):
    """The draft's burst on cuda:0 (the drawn tokens fed back on the card)
    against k chained ``decode_step_sampled`` calls on the card: the same
    tokens, distributions within 1e-6, the same ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, dcfg, dtree = _spec_lms()
    s, k = 4, 4
    draft = convert.from_jax_params(dtree, dcfg, "cuda:0")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, dcfg.vocab, n).tolist() for n in (9, 30, 64,
                                                                 5)]
    samp = _sampling([temp] * s, lm.ROLE_DRAFT, s)
    n = np.asarray([len(p) for p in prompts])

    def ring():
        cache = lm.init_kv_cache(dcfg, s, 256, device="cuda:0")
        firsts = [int(lm.prefill(draft, cache, i, p, len(p))[0].argmax())
                  for i, p in enumerate(prompts)]
        return cache, np.asarray(firsts)

    burst_ring, firsts = ring()
    toks, q, burst_ring = lm.decode_steps_sampled(draft, burst_ring, firsts,
                                                  n, k, samp)
    chained, cur = ring()
    ref_t, ref_q = [], []
    for j in range(k):
        cur, qj, chained = lm.decode_step_sampled(draft, chained, cur, n + j,
                                                  samp)
        ref_t.append(cur)
        ref_q.append(qj)
    assert toks.cpu().tolist() == torch.stack(ref_t, 1).cpu().tolist()
    assert float((q - torch.stack(ref_q, 1)).abs().max()) <= 1e-6
    for key in ("k", "v"):
        assert torch.equal(burst_ring[key], chained[key])


#: what may stay allocated after a failed trial: a worker thread's first
#: cuBLAS calls allocate its workspaces through the caching allocator
OOM_SLACK_BYTES = 64 << 20

_OOM_ONCE = b"""


class OomOnceViT(NarrowViT):
    # the first trial asks for a batch of the whole 8,192-image set, which
    # the capped allocator cannot hold; the later ones take their knob
    CALLS = [0]

    def train(self, dataset_uri):
        type(self).CALLS[0] += 1
        if type(self).CALLS[0] == 1:
            self._knobs["batch_size"] = 8192
        super().train(dataset_uri)
"""


@pytest.mark.cuda
def test_cuda_a_device_oom_trial_is_user_and_frees_the_card(tmp_path,
                                                             monkeypatch):
    """A narrow ViT trial whose batch does not fit raises PyTorch's own
    OutOfMemoryError from the allocator (capped for the test with
    set_per_process_memory_fraction): the trial is ERRORED as USER (the
    JAX package's kind for a device OOM), the memory it held is back
    before the next trial starts, and that trial completes on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pathlib import Path

    from rafiki_tpu_torch.advisor.advisor import AdvisorStore
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.device import ServiceContext
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.worker import train

    source = (Path(__file__).resolve().parents[1] / "rafiki_tpu_torch"
              / "templates" / "torch_vit.py").read_text()
    for old, new in _NARROW_EDITS:
        source = source.replace(old, new)
    rng = np.random.default_rng(0)
    uris = {}
    for split, n in (("train", 8192), ("test", 64)):
        x = rng.random((n, 32, 32, 3), dtype=np.float32)
        y = rng.integers(0, 10, n).astype(np.int32)
        uris[split] = write_numpy_dataset(x, y, str(tmp_path / f"{split}.npz"))
    db = Database(":memory:")
    user = db.create_user("u@x", "h", "MODEL_DEVELOPER")
    model = db.create_model(user["id"], "vit", "IMAGE_CLASSIFICATION",
                            source.encode() + _OOM_ONCE, "OomOnceViT", {},
                            "PRIVATE")
    job = db.create_train_job(user["id"], "a", 1, "IMAGE_CLASSIFICATION",
                              uris["train"], uris["test"],
                              {"MODEL_TRIAL_COUNT": 2})
    sub = db.create_sub_train_job(job["id"], model["id"])
    entry = []
    real = train.TrainWorker._run_trial

    def run_trial(self, *args, **kw):
        torch.cuda.synchronize()
        entry.append(torch.cuda.memory_allocated(0))
        return real(self, *args, **kw)

    monkeypatch.setattr(train.TrainWorker, "_run_trial", run_trial)
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_allocated(0) + (1 << 30)
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        train.TrainWorker(sub["id"], db, AdvisorStore(),
                          params_dir=str(tmp_path / "params")).start(
            ServiceContext("svc", chips=[0]))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
    first, second = sorted(db.get_trials_of_sub_train_job(sub["id"]),
                           key=lambda t: t["datetime_started"])
    assert (first["status"], first["fault_kind"]) == ("ERRORED", "USER")
    assert "OutOfMemoryError" in first["fault_detail"]
    assert second["status"] == "COMPLETED" and np.isfinite(second["score"])
    assert len(entry) == 2
    assert entry[1] - entry[0] <= OOM_SLACK_BYTES, entry


@pytest.mark.cuda
def test_cuda_fit_resumed_from_a_checkpoint_ends_where_the_fit_ends(
        tmp_path):
    """A narrow ViT fit for 2 epochs on cuda:0 with a checkpoint, then
    resumed to 3 in a fresh model and AdamW (the state goes back onto the
    card), lands within twice the distance between two uninterrupted
    3-epoch fits, plus 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.models.transformer import TransformerConfig
    from rafiki_tpu_torch.sdk import torch_backend
    from rafiki_tpu_torch.templates.torch_vit import _logits

    cfg = vit.ViTConfig(image_size=32, patch_size=4, num_classes=10,
                        encoder=TransformerConfig(dim=128, depth=2, heads=2))
    rng = np.random.default_rng(0)
    x = rng.random((96, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, 96).astype(np.int32)
    tree = vit.init(np.random.default_rng(1), cfg)

    def fit(epochs, path=None):
        trainer = torch_backend.DataParallelTrainer(
            torch_backend.softmax_classifier_loss(_logits),
            torch_backend.tunable_optimizer(
                torch.optim.AdamW, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=1e-4), device="cuda:0")
        model, opt = trainer.init(lambda r: convert.from_jax_params(
            tree, cfg, "cuda:0", train=True))
        logged = []
        trainer.fit(model, opt, (x, y), epochs=epochs, batch_size=16, seed=3,
                    log=lambda **m: logged.append(m["epoch"]),
                    checkpoint_path=path)
        states = [s for s in opt.state.values()]
        assert all(v.device.type == "cuda" for s in states
                   for k, v in s.items() if k != "step")
        return {k: v.detach().float().cpu().numpy()
                for k, v in model.state_dict().items()}, logged

    a, _ = fit(3)
    b, _ = fit(3)
    path = str(tmp_path / "trial.ckpt")
    _, first = fit(2, path)
    resumed, second = fit(3, path)
    assert first == [0.0, 1.0] and second == [2.0]
    runs = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    off = max(float(np.abs(resumed[k] - a[k]).max()) for k in a)
    assert off <= 2 * runs + 1e-6, (off, runs)


# ---------------------------------------------------------------------------
# several cards: a data group of NCCL ranks, one process a card
# ---------------------------------------------------------------------------

def _need_cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


def _on_cards(n, fn, *args):
    """``fn(*args)`` on ranks over cuda:0..n-1, this thread rank 0."""
    from rafiki_tpu_torch.device import set_device_grant
    from rafiki_tpu_torch.parallel import ranks

    devices = list(range(n))
    set_device_grant(devices)
    try:
        with ranks.Ranks(devices) as r:
            ranks.set_group(r.group)
            try:
                return r.run(fn, *args)
            finally:
                ranks.set_group(None)
    finally:
        set_device_grant(None)


def rank_collectives():
    """Rank side: a sum, a copy from rank 0 and a gather on the card."""
    from rafiki_tpu_torch.parallel import ranks

    g = ranks.current_group()
    summed = g.all_reduce_(torch.full((3,), g.rank + 1.0, device=g.device))
    copied = g.broadcast_(torch.full((2,), float(g.rank), device=g.device))
    gathered = g.all_gather(torch.tensor([g.rank], device=g.device))
    return (str(summed.device), summed.tolist(), copied.tolist(),
            gathered.flatten().tolist())


@pytest.mark.cuda
def test_cuda_ranks_sum_copy_and_gather_over_two_cards():
    """NCCL ranks on cuda:0 and cuda:1, one process each: the sum, the
    copy from rank 0 and the gather in rank order."""
    _need_cards(2)
    out = _on_cards(2, rank_collectives)
    assert [o[0] for o in out] == ["cuda:0", "cuda:1"]
    assert all(o[1:] == ([3.0] * 3, [0.0, 0.0], [0, 1]) for o in out)


def rank_resnet_step(batch_rows):
    """Rank side: one stateful AdamW step of the narrow ResNet over a
    fixed global batch (this rank's share of it), from one tree; (the
    loss of the global batch, the averaged gradients, the running
    statistics) on the host."""
    from rafiki_tpu_torch.parallel import ranks
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        tunable_optimizer,
    )
    from rafiki_tpu_torch.templates import torch_resnet

    torch.backends.cudnn.allow_tf32 = False
    group = ranks.current_group()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (batch_rows, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, batch_rows))
    trainer = DataParallelTrainer(
        torch_resnet._loss, tunable_optimizer(torch.optim.AdamW, lr=1e-3,
                                              weight_decay=1e-4),
        stateful=True)
    dev = trainer.device
    model, opt, state = trainer.init(lambda rng: (lambda m: (m, m.state()))(
        _resnet(True, dev, train=True)))
    rows = trainer._shard(batch_rows)
    loss = trainer.train_step(model, opt, (x[rows].to(dev), y[rows].to(dev)),
                              state)
    if group is not None:
        loss = group.all_reduce_(loss.reshape(1).float())[0] / group.size
    return (float(loss), {k: v.grad.double().cpu()
                          for k, v in model.named_parameters()},
            {k: v.cpu() for k, v in state.items()})


@pytest.mark.cuda
def test_cuda_resnet_step_over_two_cards_is_one_cards():
    """One stateful step over 2 cards (16 rows each, BatchNorm moments of
    the global batch) against the same step on one card over the 32 rows,
    with the tolerances of the CPU comparison above: the loss within
    1e-2, each gradient within 5e-2 of its norm (bar the convolution
    biases), the running statistics within 1e-3; both ranks hold the same
    gradients and statistics."""
    _need_cards(2)
    from rafiki_tpu_torch.device import set_device_grant

    set_device_grant([0])
    try:
        l_one, g_one, s_one = rank_resnet_step(32)
    finally:
        set_device_grant(None)
    (l_two, g_two, s_two), (_, g_r1, s_r1) = _on_cards(2, rank_resnet_step,
                                                       32)
    assert abs(l_two - l_one) <= 1e-2
    for k, ref in g_one.items():
        assert torch.equal(g_two[k], g_r1[k]), k
        if k.endswith(("conv1.bias", "conv2.bias", "conv3.bias",
                       "proj.bias", "stem.bias")):
            continue
        assert float((g_two[k] - ref).norm()) <= 5e-2 * float(ref.norm()), k
    for k, ref in s_one.items():
        assert torch.equal(s_two[k], s_r1[k]), k
        assert float((s_two[k] - ref).abs().max()) <= 1e-3 * max(
            1.0, float(ref.abs().max())), k


CARD_PROBE = b'''
import os

import numpy as np
import torch

from rafiki_tpu_torch.parallel import ranks
from rafiki_tpu_torch.sdk.knob import FloatKnob
from rafiki_tpu_torch.sdk.model import BaseModel
from rafiki_tpu_torch.sdk.torch_backend import (
    DataParallelTrainer,
    softmax_classifier_loss,
    tunable_optimizer,
)

_steps = [0]


def _apply(model, x):
    # while the test's marker file exists: a device OOM on rank 1 alone,
    # at its 20th step
    _steps[0] += 1
    group = ranks.current_group()
    if (os.environ.get("PROBE_FAULT") == "oom" and group is not None
            and group.rank == 1 and _steps[0] == 20
            and os.path.exists(os.environ["PROBE_MARKER"])):
        torch.empty(1 << 42, dtype=torch.uint8, device=x.device)
    return model(x)


class CardProbe(BaseModel):
    """Trains over its grant's ranks; scores the number of ranks. While
    the test's marker file exists (read by every rank as the trial
    starts) the fit is long."""

    @staticmethod
    def get_knob_config():
        return {"learning_rate": FloatKnob(1e-2, 1e-1, is_exp=True)}

    def train(self, dataset_uri):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((4096, 16)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.int64)
        epochs = 100000 if os.path.exists(os.environ["PROBE_MARKER"]) else 2
        trainer = DataParallelTrainer(
            softmax_classifier_loss(_apply),
            tunable_optimizer(torch.optim.SGD,
                              lr=self._knobs["learning_rate"]))
        self._n = trainer.n_data
        self._model, opt = trainer.init(lambda rng: torch.nn.Linear(16, 2))
        trainer.fit(self._model, opt, (x, y), epochs=epochs, batch_size=64,
                    log=self.logger.log)

    def evaluate(self, dataset_uri):
        return float(self._n)

    def predict(self, queries):
        return [0 for _ in queries]

    def dump_parameters(self):
        return {"w": self._model.weight.detach().cpu().numpy()}

    def load_parameters(self, params):
        pass
'''


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["oom", "kill", "hang"])
def test_cuda_a_follower_fault_faults_its_trial_and_the_admin_goes_on(
        tmp_path, monkeypatch, fault):
    """A 2-card trial under thread placement (rank 0 in this process, as
    in an admin) whose follower, mid-fit, hits a device OOM (a USER
    fault, the follower's error), is SIGKILLed (INFRA, at once: the
    watcher aborts rank 0's communicators) or is stopped (INFRA, by the
    group's timeout of 20 s). The trial gets its fault row, this process
    lives on with its card usable, and the next trial over fresh ranks
    completes."""
    _need_cards(2)
    import multiprocessing
    import os
    import signal
    import time

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.constants import TrialStatus
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.manager import (
        ChipAllocator,
        LocalPlacementManager,
    )
    from rafiki_tpu_torch.worker.faults import FaultKind

    timeout_s = 20
    marker = tmp_path / "long"
    marker.write_text("")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_MAX", "0")
    monkeypatch.setenv("RAFIKI_DIST_TIMEOUT_S", str(timeout_s))
    monkeypatch.setenv("PROBE_FAULT", fault)
    monkeypatch.setenv("PROBE_MARKER", str(marker))
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator([0, 1])),
                  params_dir=str(tmp_path / "params"))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", CARD_PROBE,
                           "CardProbe")
        admin.create_train_job(
            uid, "fault", "IMAGE_CLASSIFICATION", "u://t", "u://e",
            budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 2,
                    "CHIPS_PER_TRIAL": 2})
        deadline = time.monotonic() + 120
        victim = None
        while time.monotonic() < deadline:
            trials = admin.get_trials_of_train_job(uid, "fault")
            if trials and trials[0]["status"] != TrialStatus.RUNNING:
                break
            if (fault != "oom" and victim is None and trials
                    and any('"epoch"' in line for line in
                            admin.db.get_trial_logs(trials[0]["id"]))):
                (victim,) = [p.pid for p in multiprocessing.active_children()
                             if p.name.startswith("rafiki-rank")]
                os.kill(victim, signal.SIGKILL if fault == "kill"
                        else signal.SIGSTOP)
                t_fault = time.monotonic()
            if fault == "oom" and victim is None and trials:
                victim, t_fault = 0, time.monotonic()
            time.sleep(0.05)
        ended_s = time.monotonic() - t_fault
        marker.unlink()  # the next trial is short
        job = admin.wait_until_train_job_stopped(uid, "fault",
                                                 timeout_s=180)
        first, second = admin.get_trials_of_train_job(uid, "fault")
        assert first["status"] == TrialStatus.ERRORED, first["status"]
        if fault == "oom":
            assert first["fault_kind"] == FaultKind.USER
            assert "OutOfMemoryError" in first["fault_detail"]
            assert "raised on rank 1" in first["fault_detail"]
        else:
            assert first["fault_kind"] == FaultKind.INFRA
            if fault == "kill":
                assert f"pid {victim}" in first["fault_detail"]
                assert ended_s < 15, ended_s
            else:
                assert ended_s < timeout_s + 30, ended_s
        assert job["status"] == "STOPPED"
        assert second["status"] == TrialStatus.COMPLETED
        assert second["score"] == 2.0
        assert float(torch.ones(4, device="cuda:0").sum()) == 4.0
    finally:
        admin.shutdown()
        if marker.exists():
            marker.unlink()


def _pop_cnn(k, device):
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.templates import torch_cnn

    tree = torch_cnn.init_params(np.random.default_rng([7, k]), 2, 16, 3, 10)
    with torch.device("meta"):
        model = torch_cnn.Cnn(2, 16, 3, 10)
    return from_jax_tree(model, tree, None, device, train=True)


@pytest.mark.cuda
def test_cuda_population_step_matches_cpu(monkeypatch):
    """The vmapped population step (K=3 TorchCnn members, cuDNN's grouped
    convolutions) on the card against the CPU, both in f32: each member's
    loss within 1e-4 relative and each gradient leaf within 1e-3
    relative L2 (phase 14a's tolerances); a step leaves the member at
    lr 0 as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch.models import core
    from rafiki_tpu_torch.sdk.population import PopulationTrainer
    from rafiki_tpu_torch.templates import torch_cnn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cast = core.cast_for_compute
    monkeypatch.setattr(core, "cast_for_compute",
                        lambda x, dtype=None: cast(x, torch.float32))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda:0"):
        t = PopulationTrainer(torch_cnn.softmax_classifier_loss(
            torch_cnn._logits), torch_cnn._adamw(), device=dev)
        params, opt = t.stack([_pop_cnn(k, dev) for k in range(3)],
                              {"lr": [0.0, 1e-3, 1e-2]})
        batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        grads, losses = t.grads(params, batch)
        out[dev] = (losses.cpu(), {k: v.cpu() for k, v in grads.items()})
        before = {k: v.clone() for k, v in params.params.items()}
        t.step(params, opt, batch)
        for name, p in params.params.items():
            assert torch.equal(p[0], before[name][0]), name
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["cuda:0"]
    torch.testing.assert_close(l_card, l_cpu, rtol=1e-4, atol=0)
    for name, want in g_cpu.items():
        for k in range(3):
            err = float((g_card[name][k] - want[k]).norm() / want[k].norm())
            assert err <= 1e-3, (name, k, err)


@pytest.mark.cuda
def test_cuda_fused_int8_bert_is_one_k1_launch_a_layer(monkeypatch):
    """Int8 serving of two stacked BERT trials: each vmap instance
    dequantizes its own int8 weights, K1 launches once a layer over both
    trials' rows, and each trial's answer equals its solo int8 answer
    within 1e-4 (``tests/test_fused_ensemble.py``'s rule; the embedding
    computes in f32 here, as bf16 products batched and alone round
    apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import bert, core
    from rafiki_tpu_torch.sdk import quant
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    emb = core.embedding
    monkeypatch.setattr(core, "embedding",
                        lambda p, ids, dtype=None: emb(p, ids, torch.float32))
    cfg = bert.tiny(vocab=2000, max_len=64, dim=128, depth=2, heads=2)
    models = [convert.from_jax_params(bert.init(
        np.random.default_rng(s), cfg), cfg, "cuda:0") for s in (0, 1)]
    t8 = DataParallelTrainer(
        predict_fn=lambda m, ids: torch.softmax(m(ids), -1),
        device="cuda:0", serve_int8=True)
    ids = np.random.default_rng(2).integers(2, 2000, (8, 64)).astype(
        np.int32)
    solo = [t8.predict_batched(m, ids, batch_size=8) for m in models]
    stacked = t8.stack_ensemble_params(models)
    assert quant.is_quantized_leaf(stacked.params["model.embed.table"])
    flash_attention.launches = 0
    fused = t8.predict_batched_stacked(stacked, ids, batch_size=8)
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.encoder.depth
    np.testing.assert_allclose(fused, np.stack(solo), atol=1e-4, rtol=0)


def _narrow_vit_admin(tmp_path, n_trials):
    """An admin on ``cuda:0`` alone (a one-card host, whatever the
    machine has) holding a STOPPED train job of ``n_trials`` COMPLETED
    narrow-ViT trials whose parameters are seeded ``vit.init`` trees (no
    training)."""
    from pathlib import Path

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.models.transformer import TransformerConfig
    from rafiki_tpu_torch.placement.manager import (
        ChipAllocator,
        LocalPlacementManager,
    )
    from rafiki_tpu_torch.sdk.artifact import write_artifact
    from rafiki_tpu_torch.sdk.params import dump_params

    source = (Path(flash_mod.__file__).parents[1] / "templates"
              / "torch_vit.py").read_text()
    for old, new in _NARROW_EDITS:
        source = source.replace(old, new)
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator([0])),
                  params_dir=str(tmp_path / "params"))
    uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                  config.SUPERADMIN_PASSWORD)["user_id"]
    admin.create_model(uid, "narrow", "IMAGE_CLASSIFICATION",
                       source.encode(), "NarrowViT")
    model = admin.db.get_model_by_name(uid, "narrow")
    tj = admin.db.create_train_job(uid, "narrow", 1, "IMAGE_CLASSIFICATION",
                                   "t", "e", {})
    sub = admin.db.create_sub_train_job(tj["id"], model["id"])
    cfg = vit.ViTConfig(image_size=32, patch_size=4, num_classes=10,
                        encoder=TransformerConfig(dim=128, depth=2, heads=2))
    knobs = {"image_size": 32, "patch_size": 4, "dim": 128, "depth": 2,
             "heads": 2, "num_classes": 10, "learning_rate": 1e-4,
             "batch_size": 16, "epochs": 1}
    for i in range(n_trials):
        trial = admin.db.create_trial(sub["id"], model["id"], knobs)
        path = str(tmp_path / f"{trial['id']}.params")
        write_artifact(path, dump_params(vit.init(
            np.random.default_rng(i), cfg)))
        admin.db.mark_trial_as_complete(trial["id"], 0.9 - 0.1 * i, path)
    admin.db.mark_train_job_as_stopped(tj["id"])
    return admin, uid


@pytest.mark.cuda
def test_cuda_a_narrow_vit_rollout_launches_k1_in_the_new_replica(
        tmp_path, monkeypatch):
    """A rollout of a narrow ViT on the card: CANARY -> DONE under load
    with no failed request, every replica on the card, K1 launched by the
    new-version replica (its warm-up and its forwards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading
    import time

    monkeypatch.setenv("RAFIKI_ROLLOUT_JUDGE_WINDOW_S", "1.0")
    monkeypatch.setenv("RAFIKI_ROLLOUT_MIN_REQUESTS", "3")
    admin, uid = _narrow_vit_admin(tmp_path, 2)
    try:
        from rafiki_tpu_torch import config

        monkeypatch.setattr(config, "INFERENCE_MAX_BEST_TRIALS", 1)
        inf = admin.create_inference_job(uid, "narrow")
        (w0,) = inf["workers"]
        assert admin.db.get_service(w0["service_id"])["chips"] == [0]
        target = next(t["id"] for t in admin.get_trials_of_train_job(
            uid, "narrow") if t["id"] != w0["trial_id"])
        x = np.random.default_rng(1).random((4, 32, 32, 3),
                                            dtype=np.float32).tolist()
        errors, stop = [], threading.Event()

        def load():
            while not stop.is_set():
                try:
                    admin.predict(uid, "narrow", x)
                except Exception as e:
                    errors.append(repr(e))

        threads = [threading.Thread(target=load) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        k1 = flash_attention.launches
        admin.update_inference_job(uid, "narrow", -1, trial_id=target,
                                   canary_fraction=0.5)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = admin.get_rollout_status(uid, "narrow")
            if st["phase"] in ("DONE", "ROLLED_BACK", "ABORTED"):
                break
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert st["phase"] == "DONE", st
        assert errors == []
        (w1,) = admin.services.live_inference_workers(inf["id"])
        assert (w1["trial_id"], w1["model_version"]) == (target, 1)
        assert w1["chips"] == [0]
        assert flash_attention.launches > k1
        k1 = flash_attention.launches
        assert np.isfinite(admin.predict(uid, "narrow", x)).all()
        assert flash_attention.launches == k1 + 2  # depth 2, one bucket
    finally:
        admin.shutdown()


@pytest.mark.cuda
def test_cuda_a_standby_warms_up_through_k1_and_is_never_routed(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch.worker.inference import serving_stats

    admin, uid = _narrow_vit_admin(tmp_path, 1)
    try:
        inf = admin.create_inference_job(uid, "narrow")
        k1 = flash_attention.launches
        sid = admin.services.create_standby_replica(inf["id"])
        assert flash_attention.launches > k1  # its warm-up ran K1
        assert admin.db.get_service(sid)["chips"] == [0]
        x = np.zeros((2, 32, 32, 3), np.float32).tolist()
        for _ in range(5):
            admin.predict(uid, "narrow", x)
        assert serving_stats().get(sid, {}).get("queries", 0) == 0
        assert admin.services.standby_workers(inf["id"])[0][
            "service_id"] == sid
    finally:
        admin.shutdown()


def _settled_memory() -> int:
    """``cuda:0``'s allocated bytes once two reads 0.2 s apart agree (an
    earlier test's workers may still be letting go of theirs)."""
    import gc
    import time

    last = None
    for _ in range(50):
        gc.collect()
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated(0)
        if now == last:
            return now
        last = now
        time.sleep(0.2)
    return last


@pytest.mark.cuda
def test_cuda_a_drained_replica_gives_its_memory_back(tmp_path):
    """Scale a narrow-ViT job up by one replica on the card and drain it:
    the device memory its parameters held comes back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    admin, uid = _narrow_vit_admin(tmp_path, 1)
    try:
        inf = admin.create_inference_job(uid, "narrow")
        base = _settled_memory()
        report = admin.services.scale_inference_job(inf["id"], 1)
        (added,) = report["added"]
        held = _settled_memory()
        assert held > base, (base, held)
        freed, removed = admin.services.drain_replicas(inf["id"], [added])
        assert removed == [added]
        after = _settled_memory()
        assert after - base <= 0.1 * (held - base), (base, held, after)
    finally:
        admin.shutdown()


def _narrow_source_and_data(tmp_path):
    from pathlib import Path

    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset

    source = (Path(flash_mod.__file__).parents[1] / "templates"
              / "torch_vit.py").read_text()
    for old, new in _NARROW_EDITS:
        source = source.replace(old, new)
    rng = np.random.default_rng(0)
    patterns = rng.random((10, 32, 32, 3), dtype=np.float32)
    uris = []
    for name, n in (("train", 64), ("test", 16)):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = 0.6 * patterns[y] + 0.4 * rng.random((n, 32, 32, 3),
                                                 dtype=np.float32)
        uris.append(write_numpy_dataset(x, y, str(tmp_path / f"{name}.npz")))
    return source.encode(), uris


@pytest.mark.cuda
def test_cuda_a_sandboxed_child_launches_the_kernels(tmp_path, monkeypatch):
    """A narrow-ViT trial trained in a sandbox child on cuda:0 launches
    K1-LSE, K2 and K3 (2 a step) and K1 (its evaluate) in the child, from
    the libraries the parent built, read-only; a SandboxedModelServer of
    its parameters launches K1 in its child and answers as the same
    parameters' in-process forward does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os

    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.sdk import sandbox
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params

    from rafiki_tpu_torch.sdk.log import parse_logs

    torch.backends.cuda.matmul.allow_tf32 = False
    # the datasets lie in WORKDIR, where the sandbox may widen modes
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    source, (train, test) = _narrow_source_and_data(tmp_path)
    knobs = {"image_size": 32, "patch_size": 4, "dim": 128, "depth": 2,
             "heads": 2, "num_classes": 10, "learning_rate": 1e-3,
             "batch_size": 16, "epochs": 1}
    # tmp_path's ancestors (pytest's base is 0700) keep their modes: the
    # child reaches the checkout, the libraries, the data and its jail
    # through descriptors
    ancestors = [str(p) for p in tmp_path.parents]
    modes = [os.stat(p).st_mode for p in ancestors]
    lines = []
    score, params = sandbox.run_trial_sandboxed(
        source, "NarrowViT", knobs, train, test,
        sandbox.make_jail(str(tmp_path), "trial"), on_log_line=lines.append,
        devices=[0])
    report = sandbox.report_in_log(parse_logs(lines)["messages"])
    steps = 64 // 16
    assert 0 <= score <= 1
    assert report["devices"] == ["cuda:0"]
    assert report["uid_dropped"] == (os.geteuid() == 0)
    assert sorted(report["libraries"]) == sorted(
        str(_build.library_path(n)) for n in _build.SOURCES)
    assert [report["launches"][k] for k in (
        "flash_attention_lse", "flash_attention_dq",
        "flash_attention_dkv")] == [2 * steps] * 3
    assert report["launches"]["flash_attention"] == 2
    with np.load(test) as z:
        images = z["x"][:8]
    model = load_model_class(source, "NarrowViT")(**knobs)
    model.load_parameters(load_params(params))
    ref = np.asarray(model.predict(images))
    model.destroy()
    srv = sandbox.SandboxedModelServer(
        source, "NarrowViT", knobs, params,
        sandbox.make_jail(str(tmp_path), "serve"), devices=[0])
    try:
        got = np.asarray(srv.predict(images.tolist()))
        served = srv.report()
    finally:
        srv.close()
    assert served["launches"]["flash_attention"] > 0
    assert served["devices"] == ["cuda:0"]
    assert float(np.abs(got - ref).max()) <= 1e-3
    assert [os.stat(p).st_mode for p in ancestors] == modes, ancestors


# ---------------------------------------------------------------------------
# crash recovery on the card: an adopted train child, a fenced serving one
# ---------------------------------------------------------------------------

_ADMIN1 = """
import sys, time
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.process import ProcessPlacementManager

admin = Admin(db=Database(sys.argv[1]), params_dir=sys.argv[2],
              placement=ProcessPlacementManager(orphan_survivable=True))
print(AdminServer(admin).start().port, flush=True)
time.sleep(3600)
"""

#: a narrow ViT that holds each epoch's report for a second: its trial
#: outlives the admin's death
_SLOW_NARROW = b"""
import time


class SlowNarrowViT(NarrowViT):
    def train(self, dataset_uri):
        report = self.logger.log

        def held(*args, **metrics):
            report(*args, **metrics)
            time.sleep(1.0)

        self.logger.log = held
        super().train(dataset_uri)
"""


def _service_records(logs, sid, kind):
    import json
    import re

    return [json.loads(m.group(2)) | {"pid": int(m.group(1))}
            for m in re.finditer(kind + r" \(pid (\d+)\): (\{.*\})",
                                 (logs / f"service-{sid}.log").read_text())]


def _gone(pid):
    """Not running (gone, or a zombie its new parent has not reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _until(cond, timeout_s):
    import time

    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.05)


@pytest.mark.cuda
def test_cuda_an_orphan_surviving_child_is_adopted_and_trains_on(
        tmp_path, monkeypatch):
    """The admin, a process of its own, is SIGKILLed mid-trial; its
    narrow-ViT train child on the card (``RAFIKI_ORPHAN_SURVIVE=1``)
    trains on; an admin booted on the same store and port adopts it by
    pid with its card, and it finishes: K1-LSE, K2 and K3 2 a step in
    all, some after its admin's death (its SIGUSR1 line), K1 2 (its
    evaluate)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager

    root = str(Path(flash_mod.__file__).resolve().parents[2])
    logs = tmp_path / "logs"
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(logs))
    store, params = str(tmp_path / "store.sqlite3"), str(tmp_path / "params")
    source, uris = _narrow_source_and_data(tmp_path)
    source = source.replace(b'"epochs": FixedKnob(1)',
                            b'"epochs": FixedKnob(3)') + _SLOW_NARROW
    admin1 = subprocess.Popen(
        [sys.executable, "-c", _ADMIN1, store, params], cwd=root,
        env={**os.environ, "PYTHONPATH": root}, stdout=subprocess.PIPE,
        text=True)
    admin2 = srv2 = pid = None
    try:
        port = int(admin1.stdout.readline())
        c = Client("127.0.0.1", port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("slow", "IMAGE_CLASSIFICATION", source,
                       "SlowNarrowViT")
        c.create_train_job("slow", "IMAGE_CLASSIFICATION", *uris,
                           budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1})
        db = Database(store)
        job_id = c.get_train_job("slow")["id"]
        (sid,) = [w["service_id"] for w in c.get_train_job("slow")["workers"]]
        _until(lambda: db.get_trials_of_train_job(job_id), 300)
        pid = db.get_service(sid)["pid"]
        admin1.kill()
        admin1.wait(timeout=30)
        os.kill(pid, signal.SIGUSR1)  # its launches when its admin died
        admin2 = Admin(db=Database(store), params_dir=params,
                       placement=ProcessPlacementManager(
                           orphan_survivable=True))
        srv2 = AdminServer(admin2, port=port).start()
        _until(lambda: admin2.recovery_status()["state"] == "ready", 60)
        assert admin2.recovery_status()["adopted"] == 1
        assert admin2.placement.allocator.free_chips == (
            admin2.placement.allocator.total_chips - 1)
        _until(lambda: db.get_train_job(job_id)["status"] == "STOPPED", 300)
        _until(lambda: _gone(pid), 60)
        trial = db.get_trials_of_train_job(job_id)[0]
    finally:
        if srv2 is not None:
            srv2.stop()
        if admin2 is not None:
            admin2.shutdown()
        if admin1.poll() is None:
            admin1.kill()
        admin1.wait(timeout=30)
        if pid is not None and not _gone(pid):
            os.kill(pid, signal.SIGKILL)
    assert trial["status"] == "COMPLETED"
    steps = 3 * (64 // trial["knobs"]["batch_size"])
    (so_far,) = _service_records(logs, sid, "kernel launches so far")
    (total,) = _service_records(logs, sid, "kernel launches")
    names = ("flash_attention_lse", "flash_attention_dq",
             "flash_attention_dkv")
    assert [total[k] for k in names] == [2 * steps] * 3
    assert total["flash_attention"] == 2
    assert all(total[k] > so_far[k] for k in names), (so_far, total)
    log = (logs / f"service-{sid}.log").read_text()
    assert "surviving for the next admin" in log


@pytest.mark.cuda
def test_cuda_a_fenced_serving_child_gives_the_card_its_memory_back(
        tmp_path, monkeypatch):
    """A narrow-ViT serving child outlives its abandoned admin (its door
    closed, its engine silent); an admin booted on the same store fences
    it (SIGTERM: its data plane died with the old admin), errors the
    replica and its job, and the child's memory on the card comes
    back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager

    monkeypatch.setenv("RAFIKI_PLACEMENT", "process")
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("RAFIKI_SHM_RING_BYTES", str(4 << 20))
    monkeypatch.setenv("INFERENCE_MAX_BEST_TRIALS", "1")
    monkeypatch.setattr(config, "INFERENCE_MAX_BEST_TRIALS", 1)
    store = str(tmp_path / "store.sqlite3")
    source, uris = _narrow_source_and_data(tmp_path)
    admin1 = Admin(db=Database(store), params_dir=str(tmp_path / "params"))
    srv1 = AdminServer(admin1).start()
    admin2 = None
    try:
        c = Client("127.0.0.1", srv1.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("narrow", "IMAGE_CLASSIFICATION", source, "NarrowViT")
        c.create_train_job("narrow", "IMAGE_CLASSIFICATION", *uris,
                           budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1})
        assert c.wait_until_train_job_stopped(
            "narrow", timeout_s=300)["status"] == "STOPPED"
        inf = c.create_inference_job("narrow")
        (sid,) = [w["service_id"] for w in inf["workers"]]
        pid = admin1.db.get_service(sid)["pid"]
        held = torch.cuda.mem_get_info(0)[0]
        # the first admin dies: its door dark, its engine silent
        srv1.stop()
        admin1.placement.on_status = None
        admin2 = Admin(db=Database(store), params_dir=str(tmp_path / "p2"))
        _until(lambda: admin2.recovery_status()["state"] == "ready", 60)
        report = admin2.recovery_status()
        _until(lambda: _gone(pid), 60)
        _until(lambda: torch.cuda.mem_get_info(0)[0] > held, 30)
        freed = torch.cuda.mem_get_info(0)[0] - held
        db = Database(store)
        assert report["errored"] == 1 and report["adopted"] == 0, report
        # ERRORED by recovery, or STOPPED by the child's own SIGTERM
        # handling after it, as in JAX
        assert db.get_service(sid)["status"] in ("ERRORED", "STOPPED")
        assert db.get_inference_job(inf["id"])["status"] == "ERRORED"
        assert freed >= 100 << 20, freed  # at least its CUDA context
    finally:
        if admin2 is not None:
            admin2.shutdown()
        admin1.placement.on_status = None
        admin1.shutdown()
