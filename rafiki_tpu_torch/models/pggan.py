"""Progressive GAN: equalized-LR layers, WGAN-GP + ACGAN losses, the growth
schedule and the trainer with its EMA generator.

Counterpart of ``rafiki_tpu/models/pggan.py``. The same functions on
tensors (NHWC activations, compute in ``cfg.compute_dtype``, bf16 by
default; parameters, the EMA and Adam's state f32), with the parameters
held as modules whose names follow the JAX tree (``latent_dense.w``,
``torgb.0.w``, ``blocks.1.conv0.w``), so ``convert.py`` maps them by
path. An :class:`EqConv` kernel is OIHW in ``channels_last`` memory here
and HWIO there.

Where the port keeps the JAX package's semantics by hand:

- **The draws.** The trainer draws its keys, latents and the penalty's
  mixing weights with :mod:`rafiki_tpu_torch.utils.jrandom` (``jax.random``
  on the host, bit for bit), and initialises the parameters with the same
  draws as ``g_init``/``d_init``: a trial of the port runs the JAX
  trainer's numbers.
- **Stage weights** are host floats rounded to the compute type, as JAX
  casts its f32 weights before the multiply; a dormant stage's weight is
  0 and its convs still run, as in JAX.
- **The penalty's double backward.** ``d_loss_fn`` takes the critic's
  gradient with respect to the interpolates with ``create_graph=True``
  and the D step differentiates the loss through it; G's forward inside
  the D step runs without a graph.
- **Adam as optax keeps it.** One step count per optimizer, every leaf a
  gradient (zeros where a step does not reach it: the dormant stages
  above ``max_stage`` and their RGB heads), and a reset that clears the
  step counts with the moments.
- **Over ranks** (``group``, a :class:`~rafiki_tpu_torch.parallel.ranks.
  DataGroup`): every rank draws the same global batch and takes its
  contiguous part; the losses are global means, the gradients are
  averaged over the ranks, and ``minibatch_stddev`` takes its statistic
  over the global batch (a group spans the ranks: ``reshape(g, n//g)``
  puts samples j, j + n/g, ... together), through a differentiable
  all-gather whose backward is a reduce-scatter and back, so the
  penalty's double backward crosses the ranks too. The result is one
  device's function, as the JAX mesh run is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.device import default_device
from rafiki_tpu_torch.utils import jrandom

Tree = Dict[str, Any]
SQRT2 = math.sqrt(2.0)


# ---------------------------------------------------------------------------
# config

@dataclass(frozen=True)
class PgganConfig:
    resolution: int = 32          # final output resolution (power of 2, >= 8)
    num_channels: int = 3
    label_size: int = 0           # >0 enables ACGAN conditioning
    latent_size: int = 128
    fmap_base: int = 1024
    fmap_decay: float = 1.0
    fmap_max: int = 128
    gp_lambda: float = 10.0       # WGAN-GP gradient penalty weight
    eps_drift: float = 1e-3       # drift penalty on real scores
    cond_weight: float = 1.0      # ACGAN label-loss weight
    mbstd_group_size: int = 4
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def num_stages(self) -> int:
        """Stage s renders at 4*2**s; stage 0 is 4x4."""
        return int(math.log2(self.resolution)) - 1

    def nf(self, stage: int) -> int:
        return min(int(self.fmap_base / (2.0 ** (stage * self.fmap_decay))),
                   self.fmap_max)


# ---------------------------------------------------------------------------
# parameters: JAX-layout numpy trees drawn as g_init/d_init draw them, and
# the modules that hold them

def _dense_init(key: np.ndarray, in_dim: int, out_dim: int) -> Tree:
    return {"w": jrandom.normal(key, (in_dim, out_dim)),
            "b": np.zeros((out_dim,), np.float32)}


def _conv_init(key: np.ndarray, k: int, cin: int, cout: int) -> Tree:
    return {"w": jrandom.normal(key, (k, k, cin, cout)),
            "b": np.zeros((cout,), np.float32)}


def g_init(key: np.ndarray, cfg: PgganConfig) -> Tree:
    """The generator's JAX-layout tree, ``g_init``'s draws."""
    keys = iter(jrandom.split(key, 4 * cfg.num_stages + 4))
    in_dim = cfg.latent_size + cfg.label_size
    p: Tree = {
        "latent_dense": _dense_init(next(keys), in_dim, cfg.nf(0) * 16),
        "stage0_conv": _conv_init(next(keys), 3, cfg.nf(0), cfg.nf(0)),
        "torgb": [_conv_init(next(keys), 1, cfg.nf(0), cfg.num_channels)],
        "blocks": [],
    }
    for s in range(1, cfg.num_stages):
        p["blocks"].append({
            "conv0": _conv_init(next(keys), 3, cfg.nf(s - 1), cfg.nf(s)),
            "conv1": _conv_init(next(keys), 3, cfg.nf(s), cfg.nf(s)),
        })
        p["torgb"].append(_conv_init(next(keys), 1, cfg.nf(s),
                                     cfg.num_channels))
    return p


def d_init(key: np.ndarray, cfg: PgganConfig) -> Tree:
    """The discriminator's JAX-layout tree, ``d_init``'s draws."""
    keys = iter(jrandom.split(key, 4 * cfg.num_stages + 6))
    p: Tree = {"fromrgb": [], "blocks": []}
    for s in range(cfg.num_stages):
        p["fromrgb"].append(_conv_init(next(keys), 1, cfg.num_channels,
                                       cfg.nf(s)))
    for s in range(cfg.num_stages - 1, 0, -1):
        p["blocks"].append({
            "conv0": _conv_init(next(keys), 3, cfg.nf(s), cfg.nf(s)),
            "conv1": _conv_init(next(keys), 3, cfg.nf(s), cfg.nf(s - 1)),
        })
    p["stage0_conv"] = _conv_init(next(keys), 3, cfg.nf(0) + 1, cfg.nf(0))
    p["stage0_dense"] = _dense_init(next(keys), cfg.nf(0) * 16, cfg.nf(0))
    p["head"] = _dense_init(next(keys), cfg.nf(0), 1 + cfg.label_size)
    return p


class EqDense(torch.nn.Module):
    """w (in, out) stored N(0, 1), b (out,)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = torch.nn.Parameter(torch.empty(in_dim, out_dim))
        self.b = torch.nn.Parameter(torch.empty(out_dim))


class EqConv(torch.nn.Module):
    """w (out, in, k, k) in ``channels_last`` memory, stored N(0, 1);
    b (out,)."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.w = torch.nn.Parameter(torch.empty(cout, cin, k, k).contiguous(
            memory_format=torch.channels_last))
        self.b = torch.nn.Parameter(torch.empty(cout))


class Generator(torch.nn.Module):
    def __init__(self, cfg: PgganConfig):
        super().__init__()
        nf, ns, c = cfg.nf, cfg.num_stages, cfg.num_channels
        self.latent_dense = EqDense(cfg.latent_size + cfg.label_size,
                                    nf(0) * 16)
        self.stage0_conv = EqConv(3, nf(0), nf(0))
        self.torgb = torch.nn.ModuleList(EqConv(1, nf(s), c)
                                         for s in range(ns))
        self.blocks = torch.nn.ModuleList(
            torch.nn.ModuleDict({"conv0": EqConv(3, nf(s - 1), nf(s)),
                                 "conv1": EqConv(3, nf(s), nf(s))})
            for s in range(1, ns))


class Discriminator(torch.nn.Module):
    def __init__(self, cfg: PgganConfig):
        super().__init__()
        nf, ns, c = cfg.nf, cfg.num_stages, cfg.num_channels
        self.fromrgb = torch.nn.ModuleList(EqConv(1, c, nf(s))
                                           for s in range(ns))
        self.blocks = torch.nn.ModuleList(
            torch.nn.ModuleDict({"conv0": EqConv(3, nf(s), nf(s)),
                                 "conv1": EqConv(3, nf(s), nf(s - 1))})
            for s in range(ns - 1, 0, -1))
        self.stage0_conv = EqConv(3, nf(0) + 1, nf(0))
        self.stage0_dense = EqDense(nf(0) * 16, nf(0))
        self.head = EqDense(nf(0), 1 + cfg.label_size)


def build(tree: Tree, cfg: PgganConfig, kind: str,
          device=None) -> torch.nn.Module:
    """The :class:`Generator` (``kind="g"``) or :class:`Discriminator`
    (``"d"``) holding the JAX-layout ``tree`` on ``device``."""
    from rafiki_tpu_torch.convert import from_jax_tree

    with torch.device("meta"):
        model = Generator(cfg) if kind == "g" else Discriminator(cfg)
    return from_jax_tree(model, tree, device=device, train=True)


# ---------------------------------------------------------------------------
# primitive layers (equalized learning rate: the He constant is applied at
# apply time, in f32, before the cast to the compute type)

def eq_dense(p: torch.nn.Module, x: torch.Tensor,
             gain: float = SQRT2) -> torch.Tensor:
    scale = gain / math.sqrt(p.w.shape[0])
    return x @ (p.w * scale).to(x.dtype) + p.b.to(x.dtype)


def eq_conv(p: torch.nn.Module, x: torch.Tensor,
            gain: float = SQRT2) -> torch.Tensor:
    """A stride-1 ``"SAME"`` conv over NHWC ``x`` (odd square kernels pad
    k//2 on each side, as XLA does)."""
    _, cin, k, _ = p.w.shape
    scale = gain / math.sqrt(k * k * cin)
    y = F.conv2d(x.permute(0, 3, 1, 2), (p.w * scale).to(x.dtype),
                 p.b.to(x.dtype), padding=k // 2)
    return y.permute(0, 2, 3, 1)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def upscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def downscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """The reshape-mean average pool (twice differentiable)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return x.mean(dim=(2, 4))


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, in rank order; backward: each rank's rows of the
    gradient summed over the ranks (:class:`_ScatterRowSums`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ScatterRowSums.apply(grad, ctx.group), None


class _ScatterRowSums(torch.autograd.Function):
    """This rank's rows of the sum over the ranks (a reduce-scatter);
    its adjoint is the all-gather, so the pair differentiates to any
    order."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        total = group.all_reduce_(x.contiguous().clone())
        part = total.shape[0] // group.size
        return total[group.rank * part:(group.rank + 1) * part].clone()

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.group), None


def minibatch_stddev(x: torch.Tensor, group_size: int,
                     group=None) -> torch.Tensor:
    """Append one channel of batch-group stddev (the mode-collapse
    detector). Over ``group`` the statistic is the global batch's: the
    ranks' rows are gathered (differentiably), and this rank keeps its
    rows of the channel."""
    full = x.float()  # the statistic is f32 (and gloo gathers no bf16)
    if group is not None:
        full = _GatherRows.apply(full, group)
    n, h, w, _ = full.shape
    g = min(group_size, n)
    while n % g:                               # largest divisor of n <= g
        g -= 1
    y = full.reshape(g, n // g, *full.shape[1:])
    y = y - y.mean(0, keepdim=True)
    y = torch.sqrt(y.square().mean(0) + 1e-8)
    y = y.mean(dim=(1, 2, 3))                                # (n//g,)
    y = y[None, :, None, None].expand(g, n // g, h, w)
    y = y.reshape(n, h, w, 1).to(x.dtype)
    if group is not None:
        part = x.shape[0]
        y = y[group.rank * part:(group.rank + 1) * part]
    return torch.cat([x, y], dim=-1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``, whose slope at 0 is 1 (torch's
    ``leaky_relu`` takes 0.2 there: a zero-weight stage's activations sit
    at exactly 0 while its biases are)."""
    return torch.where(x >= 0, x, x * 0.2)


def stage_weights(lod: float, num_stages: int) -> np.ndarray:
    """Triangle cross-fade weights per stage for a scalar lod (f32):
    lod == num_stages-1 selects stage 0 (4x4), lod == 0 the full
    resolution, and a fractional lod blends two adjacent stages."""
    stage_lods = np.arange(num_stages - 1, -1, -1, dtype=np.float32)
    return np.clip(np.float32(1.0) - np.abs(np.float32(lod) - stage_lods),
                   np.float32(0.0), np.float32(1.0))


def _weights(lod: float, cfg: PgganConfig) -> List[float]:
    """The stage weights rounded to the compute type, as host floats."""
    w = torch.from_numpy(stage_weights(lod, cfg.num_stages))
    return w.to(cfg.compute_dtype).float().tolist()


# ---------------------------------------------------------------------------
# generator and discriminator

def g_apply(g: Generator, latents: torch.Tensor,
            labels: Optional[torch.Tensor], lod: float, cfg: PgganConfig,
            max_stage: Optional[int] = None) -> torch.Tensor:
    """latents (B, latent_size) -> images (B, R, R, C) f32 in [-1, 1].
    ``max_stage`` bounds the computed stages (the dormant convs above it
    are not run)."""
    top = cfg.num_stages - 1 if max_stage is None else max_stage
    dt = cfg.compute_dtype
    z = latents.to(dt)
    if cfg.label_size:
        if labels is None:
            raise ValueError("an ACGAN generator needs labels")
        z = torch.cat([z, labels.to(dt)], dim=-1)
    z = pixel_norm(z)
    x = eq_dense(g.latent_dense, z, gain=SQRT2 / 4.0)
    x = x.reshape(-1, 4, 4, cfg.nf(0))          # (h, w, c) order, as JAX
    x = pixel_norm(_lrelu(x))
    x = pixel_norm(_lrelu(eq_conv(g.stage0_conv, x)))

    w = _weights(lod, cfg)
    img = eq_conv(g.torgb[0], x, gain=1.0) * w[0]
    for s in range(1, top + 1):
        blk = g.blocks[s - 1]
        x = upscale2d(x)
        x = pixel_norm(_lrelu(eq_conv(blk["conv0"], x)))
        x = pixel_norm(_lrelu(eq_conv(blk["conv1"], x)))
        img = upscale2d(img) + eq_conv(g.torgb[s], x, gain=1.0) * w[s]
    for _ in range(top + 1, cfg.num_stages):
        img = upscale2d(img)
    return img.float()


def d_apply(d: Discriminator, images: torch.Tensor, lod: float,
            cfg: PgganConfig, max_stage: Optional[int] = None, group=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """images (B, R, R, C) -> (critic scores (B,) f32, label logits or
    None). The image is injected through each stage's fromRGB head with
    the generator's fade weights; over ``group`` the minibatch stddev is
    the global batch's."""
    top = cfg.num_stages - 1 if max_stage is None else max_stage
    ns = cfg.num_stages
    w = _weights(lod, cfg)
    pyramid = [images.to(cfg.compute_dtype)]
    for _ in range(ns - 1):
        pyramid.append(downscale2d(pyramid[-1]))
    # pyramid[i] has the resolution of stage ns-1-i

    x = None
    for s in range(top, 0, -1):
        inject = _lrelu(eq_conv(d.fromrgb[s], pyramid[ns - 1 - s])) * w[s]
        x = inject if x is None else x + inject
        blk = d.blocks[ns - 1 - s]
        x = _lrelu(eq_conv(blk["conv0"], x))
        x = _lrelu(eq_conv(blk["conv1"], x))
        x = downscale2d(x)
    inject = _lrelu(eq_conv(d.fromrgb[0], pyramid[-1])) * w[0]
    x = inject if x is None else x + inject

    x = minibatch_stddev(x, cfg.mbstd_group_size, group)
    x = _lrelu(eq_conv(d.stage0_conv, x))
    x = x.reshape(x.shape[0], -1)                # (h, w, c) order, as JAX
    x = _lrelu(eq_dense(d.stage0_dense, x))
    out = eq_dense(d.head, x, gain=1.0).float()
    return out[:, 0], (out[:, 1:] if cfg.label_size else None)


# ---------------------------------------------------------------------------
# losses (WGAN-GP + ACGAN + drift)

def _acgan_term(logits: Optional[torch.Tensor],
                labels: Optional[torch.Tensor],
                cfg: PgganConfig) -> torch.Tensor | float:
    if not cfg.label_size:
        return 0.0
    logp = torch.log_softmax(logits, dim=-1)
    return -cfg.cond_weight * (labels * logp).sum(-1).mean()


def g_loss_fn(g: Generator, d: Discriminator, latents: torch.Tensor,
              labels: Optional[torch.Tensor], lod: float, cfg: PgganConfig,
              max_stage: Optional[int], group=None) -> torch.Tensor:
    fakes = g_apply(g, latents, labels, lod, cfg, max_stage)
    scores, logits = d_apply(d, fakes, lod, cfg, max_stage, group)
    return -scores.mean() + _acgan_term(logits, labels, cfg)


def d_loss_fn(d: Discriminator, g: Generator, reals: torch.Tensor,
              latents: torch.Tensor, labels: Optional[torch.Tensor],
              lod: float, eps: torch.Tensor, cfg: PgganConfig,
              max_stage: Optional[int], group=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The critic's loss and {wdist, gp_norm}. ``eps`` (B, 1, 1, 1) are
    the interpolation weights (JAX draws them inside, from its key). G
    runs without a graph: only D is differentiated here."""
    with torch.no_grad():
        fakes = g_apply(g, latents, labels, lod, cfg, max_stage)
    real_scores, real_logits = d_apply(d, reals, lod, cfg, max_stage, group)
    fake_scores, fake_logits = d_apply(d, fakes, lod, cfg, max_stage, group)
    wdist = real_scores.mean() - fake_scores.mean()
    loss = -wdist

    # the gradient penalty on real/fake interpolates: second order
    mixed = (reals + eps * (fakes - reals)).requires_grad_(True)
    critic, _ = d_apply(d, mixed, lod, cfg, max_stage, group)
    grads, = torch.autograd.grad(critic.sum(), mixed, create_graph=True)
    norms = torch.sqrt(grads.float().square().sum(dim=(1, 2, 3)) + 1e-8)
    loss = loss + cfg.gp_lambda * (norms - 1.0).square().mean()
    loss = loss + cfg.eps_drift * real_scores.square().mean()
    loss = loss + _acgan_term(real_logits, labels, cfg)
    loss = loss + _acgan_term(fake_logits, labels, cfg)
    return loss, {"wdist": wdist, "gp_norm": norms.mean()}


# ---------------------------------------------------------------------------
# schedule

@dataclass(frozen=True)
class Schedule:
    lod: float
    resolution: int
    minibatch: int
    max_stage: int
    G_lrate: float
    D_lrate: float


def training_schedule(cur_nimg: int, cfg: PgganConfig,
                      minibatch_base: int = 16,
                      G_lrate: float = 1e-3, D_lrate: float = 1e-3,
                      lod_initial_resolution: int = 4,
                      lod_training_kimg: float = 600.0,
                      lod_transition_kimg: float = 600.0,
                      minibatch_dict: Optional[Dict[int, int]] = None,
                      ) -> Schedule:
    """Map training progress (images shown) to lod / minibatch / lrates:
    hold the lod for ``lod_training_kimg``, then fade it down linearly
    over ``lod_transition_kimg``, a resolution doubling a phase."""
    kimg = cur_nimg / 1000.0
    max_lod = cfg.num_stages - 1
    lod = max_lod - (math.log2(lod_initial_resolution) - 2.0)
    phase_dur = lod_training_kimg + lod_transition_kimg
    phase_idx = math.floor(kimg / phase_dur) if phase_dur > 0 else 0
    phase_kimg = kimg - phase_idx * phase_dur
    lod -= phase_idx
    if lod_transition_kimg > 0:
        lod -= max(phase_kimg - lod_training_kimg, 0.0) / lod_transition_kimg
    lod = float(np.clip(lod, 0.0, max_lod))
    cur_stage_pos = max_lod - lod
    max_stage = min(cfg.num_stages - 1, int(math.ceil(cur_stage_pos - 1e-8)))
    resolution = 4 * 2 ** max_stage
    minibatch = (minibatch_dict or {}).get(resolution, minibatch_base)
    return Schedule(lod=lod, resolution=resolution, minibatch=minibatch,
                    max_stage=max_stage, G_lrate=G_lrate, D_lrate=D_lrate)


# ---------------------------------------------------------------------------
# trainer

def _grads_of(loss: torch.Tensor, params: List[torch.nn.Parameter],
              group) -> None:
    """Set each parameter's ``.grad`` to d loss / d param, zeros where the
    loss does not reach it (optax's zero gradient: one step count for
    all), averaged over ``group``'s ranks in f32."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    if group is not None:
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        group.all_reduce_(flat).div_(group.size)
        grads = [part.view_as(g) for part, g in zip(
            flat.split([g.numel() for g in grads]), grads)]
    for p, g in zip(params, grads):
        p.grad = g


class PgganTrainer:
    """Owns G, D and Gs (the EMA generator), the two Adams and the growth
    loop. With ``group`` the trainer is one rank of a data-parallel run
    (see the module docstring)."""

    def __init__(self, cfg: PgganConfig, group=None, g_smoothing: float = 0.99,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.group = group
        self.g_smoothing = g_smoothing
        self.device = (group.device if group is not None
                       else default_device(device))
        kg, kd = jrandom.split(jrandom.PRNGKey(seed))
        g_tree = g_init(kg, cfg)
        self.g = build(g_tree, cfg, "g", self.device)
        self.d = build(d_init(kd, cfg), cfg, "d", self.device)
        self.gs = build(g_tree, cfg, "g", self.device).requires_grad_(False)
        self._opt: Dict[str, torch.optim.Optimizer] = {}
        # the lod training last ran at: generate() samples there
        self.last_lod: float = 0.0

    def init_optimizers(self, g_lr: float, d_lr: float) -> None:
        """Adam(0, 0.99, eps 1e-8), as the reference configures it."""
        for name, model, lr in (("g", self.g, g_lr), ("d", self.d, d_lr)):
            self._opt[name] = torch.optim.Adam(
                model.parameters(), lr=lr, betas=(0.0, 0.99), eps=1e-8)

    def reset_optimizer_state(self) -> None:
        """Clear Adam's moments and step counts (at each lod change)."""
        for opt in self._opt.values():
            opt.state.clear()

    def _part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a global batch."""
        if self.group is None:
            return t
        part = t.shape[0] // self.group.size
        return t[self.group.rank * part:(self.group.rank + 1) * part]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return self._part(torch.from_numpy(a)).to(self.device,
                                                  non_blocking=True)

    def d_step(self, reals: torch.Tensor, labels: Optional[torch.Tensor],
               lod: float, key: np.ndarray, minibatch: int,
               max_stage: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One critic step on this rank's ``reals``; ``key`` is split into
        the latents' and the penalty's keys, as the JAX step splits it.
        Returns the loss and its aux (device scalars, this rank's)."""
        cfg = self.cfg
        zkey, gpkey = jrandom.split(key)
        latents = self._tensor(jrandom.normal(zkey, (minibatch,
                                                     cfg.latent_size)))
        eps = self._tensor(jrandom.uniform(gpkey, (minibatch, 1, 1, 1)))
        loss, aux = d_loss_fn(self.d, self.g, reals, latents, labels, lod,
                              eps, cfg, max_stage, self.group)
        _grads_of(loss, list(self.d.parameters()), self.group)
        self._opt["d"].step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def g_step(self, labels: Optional[torch.Tensor], lod: float,
               key: np.ndarray, minibatch: int,
               max_stage: int) -> torch.Tensor:
        """One generator step, then the EMA update of Gs."""
        latents = self._tensor(jrandom.normal(key, (minibatch,
                                                    self.cfg.latent_size)))
        loss = g_loss_fn(self.g, self.d, latents, labels, lod, self.cfg,
                         max_stage, self.group)
        _grads_of(loss, list(self.g.parameters()), self.group)
        self._opt["g"].step()
        with torch.no_grad():
            gs, g = list(self.gs.parameters()), list(self.g.parameters())
            b = self.g_smoothing
            torch._foreach_mul_(gs, b)
            torch._foreach_add_(gs, torch._foreach_mul(g, 1.0 - b))
        return loss.detach()

    def _mean(self, t: torch.Tensor) -> float:
        """A per-rank scalar's mean over the ranks (the global batch's)."""
        if self.group is not None:
            t = self.group.all_reduce_(t.reshape(1).float().clone())
            t = t / self.group.size
        return float(t)

    def train(self, images: np.ndarray, labels: Optional[np.ndarray] = None,
              total_kimg: float = 2.0, D_repeats: int = 1,
              minibatch_repeats: int = 4, minibatch_base: int = 16,
              G_lrate: float = 1e-3, D_lrate: float = 1e-3,
              lod_initial_resolution: int = 4,
              reset_opt_for_new_lod: bool = True,
              lod_training_kimg: float = 600.0,
              lod_transition_kimg: float = 600.0,
              log: Optional[Callable[..., None]] = None,
              seed: int = 0) -> Dict[str, float]:
        """The growth loop. ``images`` are NHWC f32 in [-1, 1] at
        ``cfg.resolution``, fed at full resolution (D's pyramid blends
        them down); they are copied to the device once. Every rank draws
        the same global batch indices and keys."""
        cfg = self.cfg
        self.init_optimizers(G_lrate, D_lrate)
        host_rng = np.random.default_rng(seed)
        key = jrandom.PRNGKey(seed + 1)
        n_shards = 1 if self.group is None else self.group.size
        data = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(
            self.device)
        label_data = (torch.from_numpy(np.asarray(labels, np.float32)).to(
            self.device) if labels is not None and cfg.label_size else None)

        def rows(t, idx):
            return None if t is None else t[self._tensor(idx)]

        cur_nimg, prev_lod, metrics = 0, -1.0, {}
        while cur_nimg < total_kimg * 1000:
            sched = training_schedule(
                cur_nimg, cfg, minibatch_base=minibatch_base,
                G_lrate=G_lrate, D_lrate=D_lrate,
                lod_initial_resolution=lod_initial_resolution,
                lod_training_kimg=lod_training_kimg,
                lod_transition_kimg=lod_transition_kimg)
            mb = max(n_shards, (sched.minibatch // n_shards) * n_shards)
            if reset_opt_for_new_lod and prev_lod >= 0 and (
                    math.floor(sched.lod) != math.floor(prev_lod)
                    or math.ceil(sched.lod) != math.ceil(prev_lod)):
                self.reset_optimizer_state()
            prev_lod = sched.lod

            for _ in range(minibatch_repeats):
                for _ in range(D_repeats):
                    idx = host_rng.integers(0, images.shape[0], size=mb)
                    key, sub = jrandom.split(key)
                    d_loss, aux = self.d_step(
                        rows(data, idx), rows(label_data, idx), sched.lod,
                        sub, mb, sched.max_stage)
                    cur_nimg += mb
                key, sub = jrandom.split(key)
                lbls = None
                if label_data is not None:
                    idx = host_rng.integers(0, labels.shape[0], size=mb)
                    lbls = rows(label_data, idx)
                g_loss = self.g_step(lbls, sched.lod, sub, mb,
                                     sched.max_stage)

            self.last_lod = sched.lod
            metrics = {"d_loss": self._mean(d_loss),
                       "g_loss": self._mean(g_loss),
                       "wdist": self._mean(aux["wdist"]), "lod": sched.lod,
                       "kimg": cur_nimg / 1000.0}
            if log is not None:
                log("pggan tick", **metrics)
        return metrics

    @torch.inference_mode()
    def generate(self, n: int, labels: Optional[np.ndarray] = None,
                 seed: int = 0, use_ema: bool = True,
                 lod: Optional[float] = None) -> np.ndarray:
        """n images (n, R, R, C) f32 in [-1, 1] from Gs (or G) at the lod
        training last reached (or ``lod``), from the latents
        ``jax.random.normal(PRNGKey(seed), (n, latent_size))``."""
        model = self.gs if use_ema else self.g
        latents = torch.from_numpy(jrandom.normal(
            jrandom.PRNGKey(seed), (n, self.cfg.latent_size))).to(self.device)
        lbls = (torch.as_tensor(np.asarray(labels, np.float32),
                                device=self.device)
                if labels is not None else None)
        lod_val = self.last_lod if lod is None else lod
        return g_apply(model, latents, lbls, lod_val, self.cfg,
                       None).cpu().numpy()
