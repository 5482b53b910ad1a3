"""The loss and the train, prefill and serve steps.

A port of the JAX package's ``train/steps.py`` (``loss_fn``,
``make_train_step``, ``make_prefill_step``, ``make_serve_step``). The
gradient is taken by autograd through the model's
forward, whose attention and expert products run in the hand-written
kernels and their backward kernels (``kernels/flash_attention``,
``kernels/moe_gmm``) on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import api as model_api
from repro_torch.models import common as cm
from repro_torch.train import optimizer as opt

AUX_WEIGHT = 0.01   # the MoE load-balancing loss's weight in the train loss


def loss_fn(params, cfg, batch: Dict):
    """Next-token cross entropy (plus 0.01 x the MoE aux loss) and its
    metrics. The VLM's logits over its vision tokens carry no loss."""
    model = model_api.get_model(cfg)
    logits, aux = model.forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        # logits cover [vision tokens | text]; loss only on text targets
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    # next-token prediction: logits[:, :-1] predict labels[:, 1:]
    loss = cm.cross_entropy(logits[:, :-1], labels[:, 1:], cfg.vocab_size)
    if cfg.family == "moe":
        loss = loss + AUX_WEIGHT * aux
    return loss, {"lm_loss": loss, "aux": aux}


def make_train_step(cfg, oc: opt.OptConfig):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the gradient of ``loss_fn`` in every param, then one AdamW step, which
    updates ``params`` and ``opt_state`` in place. Every param must get a
    gradient (autograd raises otherwise)."""
    def train_step(params, opt_state, batch):
        flat = cm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, list(flat.values()))
        # a DTensor gradient takes its param's layout (the gradient sync of
        # a sharded step); a plain one is as it was
        grads = cm.nest({k: sh.like(g, flat[k]).contiguous() for k, g in zip(flat, grads)})
        params, opt_state, om = opt.adamw_update(oc, params, grads, opt_state)
        metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), **om)
    return train_step


def make_prefill_step(cfg):
    """prefill_step(params, batch, last=None) -> (logits, cache): the
    family's prefill, ``last`` (B,) int32 the position whose logits come
    back (the last one when None)."""
    def prefill_step(params, batch, last=None):
        return model_api.get_model(cfg).prefill(params, cfg, batch, last)
    return prefill_step


def make_serve_step(cfg):
    """serve_step(params, cache, tokens) -> (logits, cache): one decode step
    of every slot. The family's decode_step writes the cache's K/V and
    state tensors in place and returns a new ``len``; the serving engine
    captures this function in its CUDA graph on the card."""
    def serve_step(params, cache, tokens):
        return model_api.get_model(cfg).decode_step(params, cfg, cache, tokens)
    return serve_step
