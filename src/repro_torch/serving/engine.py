"""PyTorch serving engine: slot-based continuous batching.

The counterpart of ``repro.serving.engine.JaxEngine``, with the same
semantics and public surface (``submit``, ``step``, ``drain``, ``slots``,
``queue``, ``iteration_log``). A fixed pool of B decode slots shares one
pre-allocated, zeroed cache (KV, and for recurrent families the SSM and
conv state). Prefill runs per request, at a power-of-two bucket for
attention families and at the exact prompt length for recurrent ones; its
cache is copied into a free slot, and one ``step`` advances every slot by
a token; inactive slots compute garbage that is masked out, keeping the
step's shapes static.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import api as mapi
from repro_torch.models import common as cm


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


@dataclass
class EngineRequest:
    rid: int
    prompt: np.ndarray
    max_new: int
    out_tokens: List[int] = field(default_factory=list)
    submitted: float = 0.0
    prefill_done: float = 0.0
    token_times: List[float] = field(default_factory=list)


class TorchEngine:
    """Greedy decoding on the device the params lie on."""

    def __init__(self, cfg, params, max_batch: int = 8, max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.model = mapi.get_model(cfg)
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = params["ln_f"]["scale"].device
        self.cache = self.model.init_cache(cfg, max_batch, max_len,
                                           cm.compute_dtype(cfg), self.device)
        self.slots: List[Optional[EngineRequest]] = [None] * max_batch
        self.queue: List[EngineRequest] = []
        self.iteration_log: List[Tuple[str, int, float]] = []

    # ------------------------------------------------------------ plumbing
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _insert(self, pre_cache, slot: int, length: int):
        """Copy every entry of a prefill cache into ``slot`` IN PLACE: a
        per-slot state (SSM, conv tail) whole; K/V up to the prompt, zeroing
        the slot's tail up to max_len (what the slot held before must read
        as zeros)."""
        for name, buf in self.cache.items():
            if name == "len":
                buf[slot] = length
                continue
            dst, src = buf[:, slot], pre_cache[name][:, 0]
            if name in ("k", "v"):
                n = src.shape[1]
                dst[:, :n].copy_(src)
                dst[:, n:].zero_()
            else:
                dst.copy_(src)

    def submit(self, rid: int, prompt: np.ndarray, max_new: int):
        self.queue.append(EngineRequest(rid, np.asarray(prompt), max_new,
                                        submitted=time.time()))

    def _admit(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                S = len(req.prompt)
                # recurrent state absorbs trailing pads, so SSM prefill runs
                # at the exact prompt length; attention families bucket-pad
                # (pads masked via cache len = S)
                bucket = S if self.cfg.is_recurrent \
                    else min(_bucket(S), self.max_len)
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :S] = req.prompt[:bucket]
                t0 = time.time()
                batch = {"tokens": torch.from_numpy(toks).to(self.device)}
                last = torch.full((1,), S - 1, dtype=torch.int32, device=self.device)
                logits, pre_cache = self.model.prefill(self.params, self.cfg,
                                                       batch, last)
                first = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
                self._insert(pre_cache, i, S)
                self._sync()
                req.prefill_done = time.time()
                req.out_tokens.append(first)
                self.iteration_log.append(("prefill", bucket,
                                           req.prefill_done - t0))
                self.slots[i] = req

    # ---------------------------------------------------------------- step
    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit + advance every active slot one token.
        Returns [(rid, token, done)]."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        toks = np.zeros((self.max_batch,), np.int32)
        for i in active:
            toks[i] = self.slots[i].out_tokens[-1]
        t0 = time.time()
        logits, self.cache = self.model.decode_step(
            self.params, self.cfg, self.cache, torch.from_numpy(toks).to(self.device))
        nxt = torch.argmax(logits[:, :self.cfg.vocab_size], -1).cpu().numpy()
        self._sync()
        dt = time.time() - t0
        self.iteration_log.append(("decode", len(active), dt))
        out = []
        now = time.time()
        for i in active:
            req = self.slots[i]
            req.out_tokens.append(int(nxt[i]))
            req.token_times.append(now)
            done = len(req.out_tokens) - 1 >= req.max_new
            out.append((req.rid, int(nxt[i]), done))
            if done:
                self.slots[i] = None
        return out

    def drain(self) -> Dict[int, EngineRequest]:
        """Run to completion; returns finished requests by rid."""
        finished: Dict[int, EngineRequest] = {}
        while any(s is not None for s in self.slots) or self.queue:
            reqs = {s.rid: s for s in self.slots if s is not None}
            for rid, _tok, done in self.step():
                if done:
                    finished[rid] = reqs[rid]
        return finished
