"""The port's training attention against the JAX package's: K1's LSE output
and the gradients of ``flash_attention`` (K2 and K3's plain versions).

The JAX side runs its Pallas kernels interpreted on the CPU, as
``tests/test_ops.py`` does; the port's wrappers take their plain PyTorch
versions for CPU tensors. Inputs are made with numpy from a seed and handed
to both. The CUDA kernels are compared with the plain versions on the card
by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import flash_attention as jax_flash
from rafiki_tpu.ops.flash_attention import _flash_forward
from rafiki_tpu_torch.ops.attention import mha_reference
from rafiki_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_lse,
    flash_attention_plain,
)

flash_mod = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")

# f32 with f32 statistics in both packages: only summation orders differ,
# a few ulps of O(1) values (as tests/test_torch_flash_attention.py)
LSE_ATOL = 2e-5
# gradients sum one more level of products than the forward; JAX's own
# kernel-vs-reference gradient test (tests/test_ops.py) holds 1e-4
GRAD_ATOL = 1e-4

# the case list of tests/test_torch_flash_attention.py:
# (label, seed, shape kwargs, causal, block_q, block_k)
CASES = [
    ("non-causal", 0, dict(), False, 16, 16),
    ("causal", 0, dict(), True, 16, 16),
    ("S=40, 16-tiles", 1, dict(sq=40), False, 16, 16),
    ("S=40 causal", 1, dict(sq=40), True, 16, 16),
    ("Sq<Skv causal", 3, dict(b=1, sq=4, skv=32), True, 16, 16),
    ("Sq>Skv non-causal", 4, dict(b=1, sq=40, skv=24), False, 16, 16),
    ("dead rows", 5, dict(b=1, sq=32, skv=16), True, 32, 16),
]
IDS = [c[0] for c in CASES]


def _arrays(seed, b=2, h=2, sq=48, skv=None, dh=16):
    """q, k, v and an upstream gradient g, f32."""
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dh),
                  (b, h, sq, dh)))


def _jax_grads(q, k, v, g, causal, block_q, block_k, dtype=jnp.float32):
    def f(q, k, v):
        out = jax_flash(q, k, v, causal, None, block_q, block_k)
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum()

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(x, np.float32) for x in grads]


def _torch_grads(q, k, v, g, causal, block_q, block_k,
                 dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal, None, block_q, block_k)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("label,seed,shape,causal,block_q,block_k", CASES,
                         ids=IDS)
def test_lse_matches_jax(label, seed, shape, causal, block_q, block_k):
    """The plain forward's LSE against ``_flash_forward(save_lse=True)``
    (JAX keeps lse padded to the q tile; its first Sq columns are the
    rows), and +inf on the same (dead) rows in both."""
    q, k, v, _ = _arrays(seed, **shape)
    before = flash_attention_lse.launches
    out, lse, out32 = flash_attention_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, None, block_q,
        block_k)
    assert out32 is out or torch.equal(out32, out)  # f32 inputs
    assert flash_attention_lse.launches == before  # CPU: the plain version
    b, h, sq = q.shape[:3]
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    jout, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None, block_q,
                                block_k, save_lse=True)
    jlse = np.asarray(jlse)[:, :sq]
    live = np.isfinite(jlse)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), live)
    assert (lse.numpy()[~live] == np.inf).all()
    np.testing.assert_allclose(lse.numpy()[live], jlse[live], atol=LSE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=LSE_ATOL, rtol=0)


def test_lse_dead_rows_are_inf():
    q, k, v, _ = _arrays(5, b=1, sq=32, skv=16)
    _, lse, _ = flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), True, None, 16,
        return_lse=True)
    lse = lse.view(1, 2, 32)
    assert torch.isinf(lse[:, :, :16]).all() and (lse[:, :, :16] > 0).all()
    assert torch.isfinite(lse[:, :, 16:]).all()


@pytest.mark.parametrize("label,seed,shape,causal,block_q,block_k", CASES,
                         ids=IDS)
def test_grads_match_jax_f32(label, seed, shape, causal, block_q, block_k):
    """q/k/v gradients of the port's op (autograd Function, plain backward
    on CPU tensors) against ``jax.grad`` of JAX's op (custom_vjp, K2/K3
    interpreted), in f32. Dead rows get dq = 0 in both."""
    q, k, v, g = _arrays(seed, **shape)
    counts = (flash_attention_dq.launches, flash_attention_dkv.launches)
    ours = _torch_grads(q, k, v, g, causal, block_q, block_k)
    assert (flash_attention_dq.launches,
            flash_attention_dkv.launches) == counts
    ref = _jax_grads(q, k, v, g, causal, block_q, block_k)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, r, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
    if label == "dead rows":
        assert np.abs(ours[0][:, :, :16]).max() == 0.0


@pytest.mark.parametrize("label,seed,shape,causal,block_q,block_k",
                         [c for c in CASES if c[0] != "dead rows"],
                         ids=[i for i in IDS if i != "dead rows"])
def test_grads_match_autograd_through_mha_reference(label, seed, shape,
                                                    causal, block_q,
                                                    block_k):
    """Against torch autograd through the dense reference, wherever every
    row sees a key (mha_reference averages every value on a dead row)."""
    q, k, v, g = _arrays(seed, **shape)
    ours = _torch_grads(q, k, v, g, causal, block_q, block_k)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (mha_reference(tq, tk, tv, causal=causal) * torch.from_numpy(g)) \
        .sum().backward()
    for name, a, t in zip(("dq", "dk", "dv"), ours, (tq, tk, tv)):
        np.testing.assert_allclose(a, t.grad.numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_grads_match_jax_bf16():
    """bf16 in both packages (f32 inside): the gradients differ by bf16
    roundings of inputs, out and the results (2^-8 relative each), so the
    bound is relative to their size."""
    q, k, v, g = _arrays(8, sq=40)
    ours = _torch_grads(q, k, v, g, True, 16, 16, dtype=torch.bfloat16)
    ref = _jax_grads(q, k, v, g, True, 16, 16, dtype=jnp.bfloat16)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        assert np.abs(a - r).max() <= 2e-2 * max(1.0, np.abs(r).max()), name


def test_bwd_plain_is_independent_of_block():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(9, sq=40))
    out, lse, _ = flash_attention_plain(q, k, v, True, None, 16,
                                        return_lse=True)
    a = flash_attention_bwd_plain(q, k, v, out, lse, g, True, None, 16)
    b = flash_attention_bwd_plain(q, k, v, out, lse, g, True, None, 32)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=0)


def test_no_grad_takes_the_primal_path():
    """Without grad (serving) the op is the LSE-free forward: no autograd
    graph, and the same values as under grad."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(10, sq=40))
    with torch.inference_mode():
        primal = flash_attention(q, k, v, True, None, 16, 16)
    assert primal.grad_fn is None
    trained = flash_attention(q.requires_grad_(), k, v, True, None, 16, 16)
    assert trained.grad_fn is not None
    np.testing.assert_array_equal(primal.numpy(), trained.detach().numpy())


# label -> what the backward wrappers refuse before any launch
BAD_BWD = {
    "dout shape": lambda t: dict(t, dout=t["dout"][:, :, :8].contiguous()),
    "dout dtype": lambda t: dict(t, dout=t["dout"].to(torch.bfloat16)),
    "dout strided": lambda t: dict(t, dout=t["dout"].transpose(2, 3)
                                   .contiguous().transpose(2, 3)),
    "lse shape": lambda t: dict(t, lse=t["lse"][:, :8].contiguous()),
    "lse dtype": lambda t: dict(t, lse=t["lse"].double()),
    "delta strided": lambda t: dict(t, delta=t["delta"].t().contiguous()
                                    .t()),
}


@pytest.mark.parametrize("label", sorted(BAD_BWD))
def test_backward_arguments_are_checked(label):
    """What K2/K3 do not take raises before any launch (plain Python
    checks, exercised here on CPU tensors)."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(11, sq=16, dh=64))
    _, lse, _ = flash_attention_plain(q, k, v, return_lse=True)
    args = dict(dout=g, lse=lse, delta=flash_mod._delta(q, g))
    flash_mod._check_kernel_args(q, k, v, 64, 64, args["dout"])
    flash_mod._check_row_stats(q, lse=args["lse"], delta=args["delta"])
    bad = BAD_BWD[label](args)
    with pytest.raises(ValueError):
        flash_mod._check_kernel_args(q, k, v, 64, 64, bad["dout"])
        flash_mod._check_row_stats(q, lse=bad["lse"], delta=bad["delta"])


def test_mixed_devices_raise():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(12, sq=16))
    out, lse, _ = flash_attention_plain(q, k, v, return_lse=True)
    delta = flash_mod._delta(q, g)
    with pytest.raises(ValueError):
        flash_attention_dq(q, k, v, g, lse.to("meta"), out)
    with pytest.raises(ValueError):
        flash_attention_dkv(q, k.to("meta"), v, g, lse, delta)


def test_delta_from_the_f32_output():
    """delta = rowsum(dO o O) is taken from K1's f32 output. On tokens that
    share a large common component (as ViT tokens do at initialization),
    nearly uniform attention makes dP - delta a small difference, and a
    per-row error in delta adds up over every key: bf16 gradients with
    delta from the bf16-rounded output (the JAX package's choice) land far
    from the f32 ones, with delta from the f32 output close to them."""
    rng = np.random.default_rng(13)
    b, h, s, dh = 2, 2, 196, 64
    common = 4 * rng.standard_normal((1, 1, 1, dh))
    # inputs representable in bf16, so the f32 reference sees the same
    q, k, v = (torch.from_numpy(
        (common + 0.05 * rng.standard_normal((b, h, s, dh))).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        for _ in range(3))
    g = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    exact = _torch_grads(q, k, v, g, False, 64, 64)
    ours = _torch_grads(q, k, v, g, False, 64, 64, dtype=torch.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse, _ = flash_attention_plain(tq, tk, tv, False, None, 64,
                                        return_lse=True)
    rounded = flash_attention_bwd_plain(
        tq, tk, tv, out, lse, torch.from_numpy(g), False, None, 64)

    def rel(a, ref):
        return np.linalg.norm(a - ref) / np.linalg.norm(ref)

    for i, name in enumerate(("dq", "dk")):
        ours_err = rel(ours[i], exact[i])
        rounded_err = rel(rounded[i].float().numpy(), exact[i])
        assert ours_err < 0.05, (name, ours_err)
        assert rounded_err > 4 * ours_err, (name, rounded_err, ours_err)


def _mha_grads(fused_qkv, monkeypatch, readable=None):
    """bf16 multi-head attention through the flash op on CPU tensors, with
    the wrappers of K2 and K3 spied on: the gradients of x and the
    projection weights, and what the backward handed each wrapper (q, k, v,
    dO). With ``readable`` set, every layout is taken as TMA-readable (True)
    or not (False: the backward copies everything)."""
    from rafiki_tpu_torch.ops import attention as attn

    rng = np.random.default_rng(14)
    tree = attn.attention_init(rng, 64, 4)
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in tree.items()}
    x = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
    seen = []

    def spy(real):
        def call(q, k, v, dout, *args):
            seen.append((q, k, v, dout))
            return real(q, k, v, dout, *args)
        return call

    monkeypatch.setattr(flash_mod, "flash_attention_dq",
                        spy(flash_mod.flash_attention_dq))
    monkeypatch.setattr(flash_mod, "flash_attention_dkv",
                        spy(flash_mod.flash_attention_dkv))
    if readable is not None:
        monkeypatch.setattr(flash_mod, "_tma_readable", lambda t: readable)
    out = attn.multi_head_attention(params, x, use_flash=True,
                                    fused_qkv=fused_qkv)
    out.float().square().sum().backward()
    grads = [x.grad] + [params[k].grad for k in ("wq", "wk", "wv", "wo")]
    return grads, seen


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_backward_hands_bf16_views_to_k2_k3(fused_qkv, monkeypatch):
    """The backward passes the projection's bf16 views of q, k, v and the
    einsum backward's dO to K2 and K3 as they are (the kernels read them
    through their tensor maps on the card), and the gradients equal those
    of the same backward with every input copied to a contiguous tensor."""
    grads, seen = _mha_grads(fused_qkv, monkeypatch)
    assert len(seen) == 2  # one call of each wrapper, the same tensors
    assert all(a is b for a, b in zip(*seen))
    q, k, v, dout = seen[0]
    assert not any(t.is_contiguous() for t in (q, k, v))
    assert all(flash_mod._tma_readable(t) for t in (q, k, v, dout))
    copied, seen_c = _mha_grads(fused_qkv, monkeypatch, readable=False)
    assert all(t.is_contiguous() for t in seen_c[0])
    for got, ref in zip(grads, copied):
        assert torch.equal(got, ref)


def test_backward_copies_what_tma_cannot_read(monkeypatch):
    """An upstream gradient TMA cannot walk (an expanded dO, stride 0 on
    every dim, as ``out.sum()`` gives) reaches K2 and K3 as a contiguous
    copy; q, k and v stay views."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((3, 2, 24, 64)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, 64, 4, 16)) / 8).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = (torch.einsum("bsd,dhk->bhsk", x[i], w[i]).requires_grad_()
               for i in range(3))
    assert not q.is_contiguous()
    seen = []
    real = flash_mod.flash_attention_dq
    monkeypatch.setattr(
        flash_mod, "flash_attention_dq",
        lambda q, k, v, dout, *a: seen.append((q, dout)) or real(
            q, k, v, dout, *a))
    flash_attention(q, k, v, False, None, 16, 16).sum().backward()
    (q_seen, dout_seen), = seen
    assert q_seen.data_ptr() == q.data_ptr() and not q_seen.is_contiguous()
    assert dout_seen.is_contiguous() and bool((dout_seen == 1).all())
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_returns_the_delta_k3_reads(dtype):
    """K2's wrapper takes the forward's f32 output and returns (dq,
    delta); on CPU tensors delta is :func:`_delta` (the plain version of
    the bf16 kernel's own) and dq the plain K2 with it, bit for bit."""
    q, k, v, g = (torch.from_numpy(a).to(dtype)
                  for a in _arrays(16, sq=40, dh=64))
    _, lse, out32 = flash_attention_plain(q, k, v, True, None, 16,
                                          return_lse=True)
    dq, delta = flash_attention_dq(q, k, v, g, lse, out32, True, None, 16,
                                   16)
    want = flash_mod._delta(out32, g)
    assert torch.equal(delta, want)
    assert torch.equal(dq, flash_mod.flash_attention_dq_plain(
        q, k, v, g, lse, want, True, None, 16))
