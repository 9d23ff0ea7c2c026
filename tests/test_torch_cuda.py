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
    is held alone. bf16 tolerance: the kernels round P and dS to bf16
    before the second products and the gradients to bf16 at the end (2^-8
    relative each); f32: summation order and expf only. K2's delta: f32
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
    advances its own launch counter by exactly one."""
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
    assert torch.equal(out, out_l)  # the two variants write the same O
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2
    assert float((out32 - ref32).abs().max()) <= 1e-2
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
