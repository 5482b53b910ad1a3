"""AdamW with global-norm clipping and LR schedules (cosine by default; WSD,
warmup-stable-decay, for minicpm-2b per its paper), on trees of tensors.

A port of the JAX package's ``train/optimizer.py``. The moments are fp32 and
the step an int32 scalar, as there; the update rounds each param through
fp32 and back to its dtype, as there. Unlike the JAX version the update
works IN PLACE on the params and moments (no second copy of a 40 GB
training state on the card), a chunk of elements at a time, so that its
fp32 temporaries stay small. On DTensors (the dry-run's sharded step) each
rank updates the shards it holds, with the gradient norm summed over ranks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm

CHUNK = 1 << 24   # elements per step of the in-place update (64 MB of fp32 temporaries)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | wsd
    wsd_decay_frac: float = 0.1


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a number or a tensor), as an fp32
    0-d tensor on the step's device, computed in fp32 as the JAX version
    computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=step.device)  # noqa: E731
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    if oc.schedule == "wsd":
        decay_start = oc.total_steps * (1.0 - oc.wsd_decay_frac)
        frac = torch.clamp((step - decay_start) / max(oc.total_steps - decay_start, 1), 0, 1)
        return f32(oc.lr) * warm * (1.0 - frac * f32(1.0 - 0.1))
    prog = torch.clamp(step / max(oc.total_steps, 1), 0, 1)
    return f32(oc.lr) * warm * 0.5 * (1.0 + torch.cos(f32(math.pi) * prog))


def init_opt_state(params):
    """fp32 zero moments shaped like every param, and step 0 (int32)."""
    flat = cm.flatten(params)
    dev = next(iter(flat.values())).device
    zeros = lambda: cm.nest({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                             for k, p in flat.items()})
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs):
    """The moments take their params' specs (so fsdp archs get sharded
    optimizer state); the step is replicated. Flat keys, as
    ``cm.flatten(init_opt_state(params))`` gives them."""
    out = {f"{name}/{k}": s for name in ("m", "v") for k, s in param_specs.items()}
    out["step"] = P()
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(_sumsq(x) for x in cm.flatten(tree).values()))


def _sumsq(x):
    """A leaf's sum of squares in fp32, a chunk at a time (of a DTensor:
    over its local shard, then summed over the ranks that shard it)."""
    return sh.shard_sum(x, lambda t: sum(torch.sum(torch.square(c.float()))
                                         for c in t.reshape(-1).split(CHUNK)))


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt_state):
    """One AdamW step with clipping to ``oc.grad_clip`` of the global norm.
    Updates ``params`` and the moments in place; returns (params, opt_state,
    metrics) with the new step, ``grad_norm``, ``lr`` and ``grad_sq_min``,
    the smallest sum of squares of a gradient leaf (0 where a param got no
    gradient), all 0-d tensors."""
    step = sh.local(opt_state["step"]) + 1
    sumsq = [_sumsq(g) for g in cm.flatten(grads).values()]
    gnorm = torch.sqrt(sum(sumsq))
    scale = torch.clamp(oc.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = oc.betas
    lr = lr_at(oc, step)
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    flat_p, flat_g = cm.flatten(params), cm.flatten(grads)
    flat_m, flat_v = cm.flatten(opt_state["m"]), cm.flatten(opt_state["v"])
    for key, p in flat_p.items():
        # elementwise: each rank updates the shard it holds of a DTensor
        p, g, m, v = (sh.local(t) for t in (p, flat_g[key], flat_m[key], flat_v[key]))
        if not all(t.is_contiguous() for t in (p, g, m, v)):
            raise ValueError(f"adamw_update: {key}: params, grads and moments must be "
                             "contiguous (they are updated in place through flat views)")
        for pc, gc, mc, vc in zip(*(t.reshape(-1).split(CHUNK) for t in (p, g, m, v))):
            gf = gc.float() * scale
            mc.mul_(b1).add_((1 - b1) * gf)
            vc.mul_(b2).add_((1 - b2) * gf * gf)
            pf = pc.float()
            delta = (mc / c1) / (torch.sqrt(vc / c2) + oc.eps) + oc.weight_decay * pf
            pc.copy_(pf - lr * delta)
    opt_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr,
                               "grad_sq_min": torch.stack(sumsq).min()}
