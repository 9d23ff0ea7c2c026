"""Ring attention: exact attention over a sequence split over the ranks
of the ``seq`` axis.

Counterpart of ``rafiki_tpu/parallel/ring.py``: each rank holds its
sequence shard of q, k and v; the k/v shards travel around the ring
(:func:`~rafiki_tpu_torch.parallel.collectives.ppermute`, one all-to-all
a hop, its backward the inverse hop) while each rank folds its queries'
attention over the shard it holds into online-softmax statistics in f32
(plain products, as in the JAX package: there is no Pallas kernel to
port). The JAX body hops n times and drops the last hop's shards; here
the last hop is not sent. The full (S, S) score matrix never exists on
any rank.
"""

from __future__ import annotations

import math
import torch

from rafiki_tpu_torch.parallel.collectives import MeshGroups, ppermute

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: MeshGroups, causal: bool = False) -> torch.Tensor:
    """Exact attention over this rank's (B, H, S_local, Dh) shard of a
    sequence split over the ``seq`` axis of ``mesh``, scaled by
    1/sqrt(Dh); causal positions are global (shard r holds positions
    [r S_local, (r + 1) S_local))."""
    group = mesh.group("seq")
    n = mesh.size("seq")
    my = mesh.index("seq")
    s_local = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    perm = [(r, (r + 1) % n) for r in range(n)]
    iota = torch.arange(s_local, device=q.device)
    q_pos = (my * s_local + iota)[:, None]

    b, h, _, dh = q.shape
    o = torch.zeros(b, h, s_local, dh, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local, 1), NEG_INF, device=q.device)
    l = torch.zeros(b, h, s_local, 1, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (my - i) % n  # whose kv shard this rank holds at step i
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float())
        if causal:
            k_pos = (src * s_local + iota)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if i + 1 < n:
            k_cur, v_cur = (ppermute(t, group, perm) for t in (k_cur, v_cur))
    return (o / l.clamp_min(1e-30)).to(q.dtype)
