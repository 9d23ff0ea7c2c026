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
    flash_attention_plain,
)

# the module (ops/__init__ re-exports the function under the same name)
flash_mod = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")


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
    shapes = ((dict(b=2, h=3, sq=196), False),
              (dict(b=2, h=3, sq=40, skv=196), True),
              (dict(b=1, h=3, sq=196, skv=40), True))
    for (shape, causal), block_q, block_k in (
            (s, bq, bk) for s in shapes
            for bq in flash_mod.BLOCK_Q_SIZES
            for bk in flash_mod.BLOCK_K_SIZES):
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
