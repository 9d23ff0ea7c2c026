"""The multichip dry run: every parallelism mode trained one step on a
mesh of n ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` and its
``_dryrun_impl``: the same legs over the same axes (``_pow2_axes``) and
the same kinds of steps, each a :class:`~rafiki_tpu_torch.parallel.
sharding.GspmdTrainer` over ``make_train_mesh``:

1. a ViT under dp x tp x sp;
2. an MoE LM under pp x dp x ep (the depth stack split over ``pipe``
   without GPipe: every rank runs every layer);
3. an LM with ring attention under dp x sp;
4. an LM with GPipe under pp x dp;
5. leg 1's ``predict`` (tensor-split parameters, data-split batch).

:func:`dryrun_multichip` starts one rank a device (``parallel/ranks.py``:
NCCL on the card, the default; gloo on CPU entries with
``device="cpu"``), runs the legs on every rank and prints one line a leg
with its axes and loss, then the OK line. ``full=True`` takes the legs
at full width (ViT-B/16, the LM at ``LMConfig``'s widths; the
configurations of ``chip_smoke.py``'s phase 15) instead of the JAX
dryrun's tiny ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import lm, vit
from rafiki_tpu_torch.parallel import ranks
from rafiki_tpu_torch.parallel.collectives import MeshGroups
from rafiki_tpu_torch.parallel.sharding import (
    GspmdTrainer,
    P,
    make_train_mesh,
    mean_share,
)
from rafiki_tpu_torch.utils import jrandom

#: the legs' mesh axes, as ``make_train_mesh`` takes them
AXES = ("dp", "tp", "sp", "pp", "ep")


def _pow2_axes(n: int, n_axes: int) -> list:
    """Split n's factors of two across n_axes (each axis gets 2 while the
    budget lasts); the remainder is returned as the final 'dp' factor."""
    sizes = []
    for _ in range(n_axes):
        if n % 2 == 0:
            sizes.append(2)
            n //= 2
        else:
            sizes.append(1)
    return sizes + [n]


@dataclasses.dataclass
class Leg:
    """One training leg: its name, model family (``"vit"`` or ``"lm"``)
    and config, mesh axes, global batch, steps and the step keys' first
    seed (``jrandom.PRNGKey(key + i)`` at step i)."""

    name: str
    family: str
    cfg: Any
    axes: Dict[str, int]
    batch: tuple
    steps: int = 1
    key: int = 0


def legs(n: int, full: bool = False, seed: int = 0) -> List[Leg]:
    """The four training legs over ``n`` ranks: the JAX dryrun's (tiny
    models, constant batches) or, with ``full``, phase 15's (full width,
    seeded batches)."""
    tp, sp, dp = _pow2_axes(n, 2)
    ep, pp, dp2 = _pow2_axes(n, 2)
    sp3, dp3 = _pow2_axes(n, 1)
    pp4, dp4 = _pow2_axes(n, 1)
    if not full:
        return [
            Leg("ViT", "vit", vit.tiny(), dict(dp=dp, tp=tp, sp=sp),
                (np.zeros((4 * dp, 32, 32, 3), np.float32),
                 np.zeros((4 * dp,), np.int32)), key=0),
            Leg("MoE-LM", "lm", lm.tiny(depth=2, moe_experts=max(2 * ep, 2)),
                dict(dp=dp2, pp=pp, ep=ep),
                (np.ones((2 * dp2, 32), np.int32),) * 2, key=1),
            Leg("ring-LM", "lm", lm.tiny(depth=2, max_len=8 * sp3,
                                         seq_parallel="ring"),
                dict(dp=dp3, sp=sp3),
                (np.ones((2 * dp3, 8 * sp3), np.int32),) * 2, key=2),
            Leg("gpipe-LM", "lm", lm.tiny(depth=2 * pp4, pipeline="gpipe",
                                          n_microbatches=2),
                dict(dp=dp4, pp=pp4),
                (np.ones((2 * dp4, 32), np.int32),) * 2, key=3),
        ]
    rng = np.random.default_rng(seed)
    vcfg = vit.vit_b16()
    base = lm.LMConfig()

    def lm_cfg(**kw):
        return dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, **kw))

    def tokens(b, s):
        ids = rng.integers(0, base.vocab, (b, s)).astype(np.int32)
        return ids, np.ones((b, s), np.int32)

    return [
        Leg("ViT-B/16", "vit", vcfg, dict(dp=dp, tp=tp, sp=sp),
            (rng.random((64, 224, 224, 3), dtype=np.float32),
             rng.integers(0, vcfg.num_classes, 64).astype(np.int32)),
            steps=3, key=0),
        Leg("MoE-LM", "lm", lm_cfg(moe_experts=8, moe_capacity_factor=1.25),
            dict(dp=dp2, pp=pp, ep=ep), tokens(8, 512), key=1),
        Leg("ring-LM", "lm", lm_cfg(seq_parallel="ring"),
            dict(dp=dp3, sp=sp3), tokens(4, base.max_len), key=2),
        Leg("gpipe-LM", "lm", lm_cfg(pipeline="gpipe", n_microbatches=4),
            dict(dp=dp4, pp=pp4), tokens(8, 512), key=3),
    ]


def adamw(params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """optax's ``adamw(1e-3)``, the JAX dryrun's optimizer."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def vit_loss(cfg):
    def loss(params, batch, rng):
        x, y = batch
        logits = vit.apply(params, x, cfg, rng, deterministic=False)
        ce = F.cross_entropy(logits, y.long(), reduction="none")
        # the rows are split over data and the same on every seq rank
        return mean_share(ce, split=("data",)), {}

    return loss


def trainer_for(leg: Leg, groups: MeshGroups, optimizer=adamw
                ) -> GspmdTrainer:
    """``leg``'s trainer on this rank's view of its mesh."""
    cfg = leg.cfg
    if leg.family == "vit":
        return GspmdTrainer(
            vit_loss(cfg), optimizer, vit.partition_specs(cfg),
            (vit.batch_spec(), P("data")), groups,
            predict_fn=lambda p, xb: vit.apply(p, xb, cfg))
    return GspmdTrainer(
        lambda p, b, rng: lm.loss_fn(p, b, rng, cfg), optimizer,
        lm.partition_specs(cfg), lm.batch_spec(), groups)


def init_fn(leg: Leg):
    family = vit if leg.family == "vit" else lm
    return lambda rng: family.init(rng, leg.cfg)


def mesh_groups(leg: Leg, devices: Sequence[str]) -> MeshGroups:
    """This rank's view of ``leg``'s mesh over ``devices`` (the ranks'
    devices in rank order)."""
    axes = {k: leg.axes.get(k, 1) for k in AXES}
    mesh = make_train_mesh(devices=devices, **axes)
    return MeshGroups.create(mesh, ranks.current_group())


def run_legs(devices: Sequence[str], full: bool = False,
             seed: int = 0) -> List[dict]:
    """Rank side: every leg's steps and leg 1's predict on this rank;
    each leg's axes, losses and this rank's kernel launches."""
    out = []
    predicted: Optional[dict] = None
    for leg in legs(len(devices), full, seed):
        groups = mesh_groups(leg, devices)
        try:
            trainer = trainer_for(leg, groups)
            params, opt = trainer.init(init_fn(leg), seed)
            ranks.reset_launches()
            losses = []
            for i in range(leg.steps):
                params, opt, loss, _ = trainer.step(
                    params, opt, leg.batch, jrandom.PRNGKey(leg.key + i))
                losses.append(float(loss))
            out.append({"name": leg.name, "axes": leg.axes,
                        "losses": losses, "launches": ranks.launch_counts()})
            if leg.family == "vit":
                ranks.reset_launches()
                logits = trainer.predict(params, leg.batch[0])
                predicted = {"name": "serve-predict", "axes": leg.axes,
                             "rows": int(logits.shape[0]),
                             "finite": bool(torch.isfinite(logits).all()),
                             "launches": ranks.launch_counts()}
            del params, opt, trainer
        finally:
            groups.close()
        if not all(math.isfinite(v) for v in out[-1]["losses"]):
            raise RuntimeError(f"{leg.name} {leg.axes} loss: {losses}")
    if predicted is None or not predicted["finite"]:
        raise RuntimeError("sharded serving predict")
    return out + [predicted]


def _axes(axes: Dict[str, int]) -> str:
    return " ".join(f"{k}={v}" for k, v in axes.items())


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     full: bool = False, seed: int = 0) -> List[List[dict]]:
    """Start ``n_devices`` ranks on ``device`` (``"cuda"``: one card a
    rank; ``"cpu"``: gloo ranks on CPU entries), run the legs on each,
    print a line a leg and the OK line; returns every rank's records."""
    devices = [f"{device}:{i}" for i in range(n_devices)]
    with ranks.Ranks(devices) as r:
        set_device_grant(devices)
        ranks.set_group(r.group)
        try:
            records = r.run(run_legs, devices, full, seed)
        finally:
            ranks.set_group(None)
            set_device_grant(None)
    parts = []
    for rec in records[0]:
        if "losses" in rec:
            line = (f"{rec['name']} {_axes(rec['axes'])} "
                    f"loss={rec['losses'][-1]:.4f}")
        else:
            line = (f"{rec['name']} {_axes(rec['axes'])} "
                    f"batch={rec['rows']} ok")
        print(f"dryrun_multichip: {line}", flush=True)
        parts.append(line)
    print(f"dryrun_multichip OK on {n_devices} {device} ranks: "
          + "; ".join(parts), flush=True)
    return records
