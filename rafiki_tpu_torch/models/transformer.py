"""Pre-LN transformer blocks and the depth loop, sharding-annotated.

Counterpart of ``rafiki_tpu/models/transformer.py``
(``TransformerConfig``, ``block_apply``, ``stack_apply`` and
``block_partition_specs``). The JAX package scans one compiled block body
over the depth-stacked parameters; PyTorch runs eagerly, so the loop is
plain Python over the layers. :func:`stack_apply` takes the stacked tree
(a train mesh's shard of it, ``parallel/sharding.py``) or a list of
per-layer trees (:class:`Stack`'s blocks, a module each).

Every option of the JAX config is taken:

- ``moe_experts`` > 0 replaces the MLP with ``parallel/moe.py``'s
  expert-parallel MoE, whose aux loss the stack sums;
- ``seq_parallel="ring"`` routes attention through ``parallel/ring.py``
  when the current mesh's ``seq`` axis has more than one device;
- ``pipeline="gpipe"`` runs the stack through ``parallel/pipeline.py``
  when its ``pipe`` axis has more than one device (else the depth axis
  is split over ``pipe`` and every rank runs every layer, fetching each
  from the rank that holds it);
- ``remat``: ``"full"`` keeps only each block's input and runs the block
  again in the backward (``torch.utils.checkpoint``); ``"dots"`` keeps
  the outputs of the products without batch dimensions (the projections
  and the MLP) and recomputes the rest, attention included (a selective
  checkpoint policy, JAX's ``dots_with_no_batch_dims_saveable``);
- ``dropout``, its masks ``jax.random.bernoulli``'s bit for bit
  (``models/core.py``), the keys split as the JAX scan and block split
  them.

Under a mesh each block's tensor-parallel heads and MLP columns are
split over ``model`` (``ops/attention.py``; the MLP below), Megatron's
column- then row-parallel pair.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.ops.attention import (
    MultiHeadAttention,
    attention_init,
    multi_head_attention,
)
from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel.moe import (
    MoE,
    moe_apply,
    moe_init,
    moe_partition_specs,
)
from rafiki_tpu_torch.parallel.pipeline import gpipe_apply
from rafiki_tpu_torch.parallel.ring import ring_attention
from rafiki_tpu_torch.parallel.sharding import (
    P,
    activation_mesh,
    current_mesh,
    mesh_axis_size,
    shard_activations,
    tree_map,
)
from rafiki_tpu_torch.utils import jrandom


@dataclass(frozen=True)
class TransformerConfig:
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    causal: bool = False
    # None: the flash kernel on CUDA tensors, mha_reference on the CPU
    # (ops/attention.py)
    use_flash: Optional[bool] = None
    moe_experts: int = 0  # >0 replaces the MLP with an expert-parallel MoE
    moe_capacity_factor: float = 1.25
    # "ring": ring attention over the mesh's seq axis when it is > 1
    seq_parallel: Optional[str] = None
    # None, "dots" or "full" (see the module's note)
    remat: Optional[str] = None
    # "gpipe": microbatch pipelining over the mesh's pipe axis when > 1
    pipeline: Optional[str] = None
    n_microbatches: int = 4
    # one (BS, D) x (D, 3HDh) product for the q/k/v projections
    fused_qkv: bool = False


def block_init(rng: np.random.Generator, cfg: TransformerConfig) -> dict:
    hidden = cfg.dim * cfg.mlp_ratio
    params = {
        "ln1": core.layernorm_init(cfg.dim),
        "attn": attention_init(rng, cfg.dim, cfg.heads),
        "ln2": core.layernorm_init(cfg.dim),
    }
    if cfg.moe_experts > 0:
        params["moe"] = moe_init(rng, cfg.dim, hidden, cfg.moe_experts)
    else:
        params["mlp"] = {"w1": core.dense_init(rng, cfg.dim, hidden),
                         "w2": core.dense_init(rng, hidden, cfg.dim)}
    return params


def stack_trees(trees: list) -> dict:
    """Per-layer parameter trees stacked on a leading depth axis, the JAX
    package's layout (``core.stack_layers`` there)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def mlp_apply(params: dict, h: torch.Tensor) -> torch.Tensor:
    """w2(gelu(w1(h))): under a mesh w1 holds this rank's columns and w2
    its rows, summed over ``model`` before w2's bias."""
    mesh = current_mesh()
    tp = mesh.group("model") if mesh is not None else None
    h = core.gelu(core.dense(params["w1"], C.copy_to(h, tp)))
    w2 = params["w2"]
    return (C.reduce_from(h @ w2["kernel"].to(h.dtype), tp)
            + w2["bias"].to(h.dtype))


def block_apply(params: dict, x: torch.Tensor, cfg: TransformerConfig,
                rng: Optional[np.ndarray] = None,
                deterministic: bool = True) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Returns (x, aux): aux is the MoE load-balancing term (0 for dense
    blocks). ``rng`` is a ``utils/jrandom`` key."""
    mesh = current_mesh()
    x = shard_activations(x, ("data", "seq", None))
    r1 = r2 = None
    if rng is not None:
        r1, r2 = jrandom.split(rng)
    attn_fn = None
    if cfg.seq_parallel == "ring" and mesh_axis_size("seq") > 1:
        attn_fn = lambda q, k, v, causal: ring_attention(  # noqa: E731
            q, k, v, mesh, causal=causal)
    h = multi_head_attention(params["attn"], core.layernorm(params["ln1"], x),
                             causal=cfg.causal, use_flash=cfg.use_flash,
                             fused_qkv=cfg.fused_qkv, attn_fn=attn_fn)
    x = x + core.dropout(r1, h, cfg.dropout, deterministic)
    h = core.layernorm(params["ln2"], x)
    aux = torch.zeros((), device=x.device)
    if cfg.moe_experts > 0:
        h, aux = moe_apply(params["moe"], h, cfg.moe_capacity_factor)
    else:
        h = mlp_apply(params["mlp"], h)
    x = x + core.dropout(r2, h, cfg.dropout, deterministic)
    return x, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of products without batch dimensions (2-D
    products, and batched ones of a single batch), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    if op == aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, remat: Optional[str]):
    """``fn`` checkpointed as ``remat`` says. The backward runs it again
    under the mesh it first ran under, so the recomputation takes the
    same collectives."""
    if remat is None:
        return fn
    from torch.utils import checkpoint

    if remat == "full":
        kw = {}
    elif remat == "dots":
        kw = {"context_fn": functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _dots_policy)}
    else:
        raise ValueError(f"unknown remat policy {remat!r} "
                         "(expected None, 'dots' or 'full')")

    def under(mesh, *args):
        with activation_mesh(mesh):
            return fn(*args)

    def wrapped(*args):
        return checkpoint.checkpoint(under, current_mesh(), *args,
                                     use_reentrant=False, **kw)

    return wrapped


def _flatten(tree: dict, path: Tuple[str, ...] = ()
             ) -> Tuple[List[Tuple[str, ...]], List[torch.Tensor]]:
    """(paths, leaves) of a nested dict, in its order."""
    paths, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            p, l = _flatten(v, path + (k,))
            paths += p
            leaves += l
        else:
            paths.append(path + (k,))
            leaves.append(v)
    return paths, leaves


def _unflatten(paths: List[Tuple[str, ...]], leaves: Sequence[Any]) -> dict:
    out: dict = {}
    for path, t in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


class _Fetched:
    """The layers of a depth stack split over ``pipe`` without GPipe:
    layer l from the rank that holds it (``collectives.fetch``)."""

    def __init__(self, stacked: dict, mesh):
        self.group = mesh.group("pipe")
        self.paths, self.leaves = _flatten(stacked)
        self.local = self.leaves[0].shape[0]
        self.n = self.local * mesh.size("pipe")

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, l: int) -> dict:
        owner, j = divmod(l, self.local)
        return _unflatten(self.paths, C.fetch(
            [t[j] for t in self.leaves], self.group, owner))


def stack_apply(stacked: Union[dict, Sequence[dict]], x: torch.Tensor,
                cfg: TransformerConfig, rng: Optional[np.ndarray] = None,
                deterministic: bool = True) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The depth loop -> (x, summed aux loss). ``stacked`` is the
    stacked tree (under a mesh, this rank's shard of it) or a list of
    per-layer trees.

    With ``cfg.pipeline == 'gpipe'`` and a pipe axis > 1 on the current
    mesh, the loop is replaced by microbatch pipelining over the stages
    (``parallel/pipeline.py``); that path is deterministic and returns
    aux = 0."""
    block_fn = _remat_wrap(functools.partial(_block_body, cfg=cfg,
                                             deterministic=deterministic),
                           cfg.remat)
    if cfg.pipeline == "gpipe" and mesh_axis_size("pipe") > 1:
        return _gpipe(stacked, x, cfg, deterministic), torch.zeros(
            (), device=x.device)
    mesh = current_mesh()
    if isinstance(stacked, dict):
        if mesh is not None and mesh.size("pipe") > 1:
            layers: Any = _Fetched(stacked, mesh)
        else:
            paths, leaves = _flatten(stacked)
            layers = [_unflatten(paths, [t[j] for t in leaves])
                      for j in range(leaves[0].shape[0])]
    else:
        layers = stacked
    key = rng
    aux = torch.zeros((), device=x.device)
    for j in range(len(layers)):
        sub = None
        if key is not None:
            key, sub = jrandom.split(key)
        x, a = block_fn(layers[j], x, sub)
        aux = aux + a
    return x, aux


def _block_body(layer, h, sub, cfg, deterministic):
    return block_apply(layer, h, cfg, sub, deterministic)


def _gpipe(stacked: dict, x: torch.Tensor, cfg: TransformerConfig,
           deterministic: bool) -> torch.Tensor:
    if cfg.moe_experts > 0:
        raise ValueError(
            "pipeline='gpipe' does not support MoE blocks (the stage "
            "body drops the load-balancing aux loss); use GSPMD pipe "
            "weight-sharding (pipeline=None) for MoE models")
    if mesh_axis_size("model") > 1:
        raise ValueError(
            "pipeline='gpipe' cannot combine with a model (TP) axis "
            "> 1: the pipeline shard_map claims stage weights whole, "
            "which would silently all-gather TP-sharded kernels; use "
            "GSPMD pipe weight-sharding (pipeline=None) with TP")
    n_stages = mesh_axis_size("pipe")
    if cfg.depth % n_stages != 0:
        raise ValueError(
            f"stack depth {cfg.depth} not divisible by {n_stages} pipeline "
            "stages")
    if cfg.dropout > 0 and not deterministic:
        raise ValueError(
            "pipeline='gpipe' is deterministic (no dropout-rng "
            "threading across stages); set dropout=0 or pipeline=None")
    mesh = current_mesh()
    global_batch = x.shape[0] * mesh.size("data")
    if global_batch % cfg.n_microbatches != 0:
        raise ValueError(
            f"batch {global_batch} not divisible by "
            f"n_microbatches={cfg.n_microbatches}")
    if not isinstance(stacked, dict):
        raise ValueError("pipeline='gpipe' runs over a stacked tree")
    paths, leaves = _flatten(stacked)
    if leaves[0].shape[0] * n_stages != cfg.depth:
        raise ValueError(f"a stage holds {leaves[0].shape[0]} layers of "
                         f"{cfg.depth} over {n_stages} stages")

    def structure(own, j):
        return _unflatten(paths, [t[j] for t in own])

    body = _remat_wrap(functools.partial(_stage_block, cfg=cfg), cfg.remat)
    # a sequence split over seq runs whole through the stages
    seq = mesh.group("seq")
    h = C.all_gather(x, seq, 1)
    y = gpipe_apply(body, leaves, structure, h, mesh, cfg.n_microbatches)
    if seq is not None:
        y = y.chunk(seq.size, 1)[seq.rank]
    return y


def _stage_block(layer, h, cfg):
    # plain per-stage compute: no collective inside the pipeline's body
    with activation_mesh(None):
        y, _ = block_apply(layer, h, cfg, None, True)
    return y


def block_partition_specs(cfg: TransformerConfig, stacked: bool = True
                          ) -> dict:
    """PartitionSpecs for one block (or the depth-stacked tree): the
    Megatron split, column-parallel qkv/w1, row-parallel wo/w2, the depth
    axis over ``pipe``."""
    lead = ("pipe",) if stacked else ()

    def spec(*axes):
        return P(*(lead + axes))

    specs = {
        "ln1": {"scale": spec(None), "bias": spec(None)},
        "attn": {
            "wq": spec(None, "model", None),
            "wk": spec(None, "model", None),
            "wv": spec(None, "model", None),
            "wo": spec("model", None, None),
            "bo": spec(None),
        },
        "ln2": {"scale": spec(None), "bias": spec(None)},
    }
    if cfg.moe_experts > 0:
        specs["moe"] = tree_map(lambda s: P(*(lead + tuple(s))),
                                moe_partition_specs())
    else:
        specs["mlp"] = {
            "w1": {"kernel": spec(None, "model"), "bias": spec("model")},
            "w2": {"kernel": spec("model", None), "bias": spec(None)},
        }
    return specs


class Block(torch.nn.Module):
    """One pre-LN block's parameters in the JAX layout; its forward is
    :func:`block_apply`."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.dim * cfg.mlp_ratio
        self.ln1 = core.LayerNorm(cfg.dim, device)
        self.attn = MultiHeadAttention(cfg.dim, cfg.heads, device)
        self.ln2 = core.LayerNorm(cfg.dim, device)
        if cfg.moe_experts > 0:
            self.moe = MoE(cfg.dim, hidden, cfg.moe_experts, device)
        else:
            self.mlp = torch.nn.ModuleDict({
                "w1": core.Dense(cfg.dim, hidden, device),
                "w2": core.Dense(hidden, cfg.dim, device)})

    def tree(self) -> dict:
        """This block's parameters as the JAX layout's per-layer tree."""
        own = core.own_params
        tree = {"ln1": own(self.ln1), "attn": own(self.attn),
                "ln2": own(self.ln2)}
        if self.cfg.moe_experts > 0:
            tree["moe"] = own(self.moe)
        else:
            tree["mlp"] = {k: own(m) for k, m in self.mlp.items()}
        return tree

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return block_apply(self.tree(), x, self.cfg)[0]


class Stack(torch.nn.ModuleList):
    """The depth loop over :class:`Block` s."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__([Block(cfg, device) for _ in range(cfg.depth)])
        self.cfg = cfg

    def run(self, x: torch.Tensor, rng: Optional[np.ndarray] = None,
              deterministic: bool = True) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(x, summed aux loss): :func:`stack_apply` over the blocks."""
        return stack_apply([b.tree() for b in self], x, self.cfg, rng,
                           deterministic)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x)[0]
