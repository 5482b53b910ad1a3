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

JaxEngine compiles its decode step once (``jax.jit`` of
``make_serve_step``, the cache donated). Here its counterpart is one CUDA
graph: on the card the engine captures ``decode_body`` (the serve step,
the argmax into the next-token buffer and the copy of the new ``len``)
once, over static token buffers and the cache, whose tensors every step
updates in place and nothing ever rebinds; each ``step`` then replays it.
On the CPU the same body runs eagerly over the same buffers. Prefill runs
eagerly on both.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.train import steps


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def decode_body(serve_step, vocab_size, params, cache, tokens, next_tokens):
    """One decode step of every slot over static buffers: ``serve_step``
    (which writes the cache's K/V and state tensors in place), the greedy
    token of each slot into ``next_tokens`` and the new lengths into
    ``cache["len"]``, in place. No host read of device data: the engine
    captures it in a CUDA graph. Returns the logits."""
    with torch.no_grad():
        logits, new = serve_step(params, cache, tokens)
        next_tokens.copy_(torch.argmax(logits[:, :vocab_size], -1))
        cache["len"].copy_(new["len"])
    return logits


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
    """Greedy decoding on the device the params lie on.

    On the card, the constructor captures the decode step as one CUDA graph
    (``graph``) and every ``step`` replays it (``replays`` counts them): a
    warm-up of ``decode_body`` on the engine's cache, on the capture
    stream, first builds the kernels, sets their function attributes and
    makes the buffers their wrappers keep per stream, so that capture calls
    nothing a stream capture forbids. A capture that fails raises: there
    is no eager fallback on the card. (Served params are plain tensors,
    under a mesh too; no kernel takes a DTensor on the card.)
    ``iteration_log``'s decode rows time the whole step, replay or eager:
    writing the tokens, the step, and reading the next tokens back.
    """

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
        self._serve = steps.make_serve_step(cfg)
        self._prefill = steps.make_prefill_step(cfg)
        on_card = self.device.type == "cuda"
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.next_tokens = torch.zeros_like(self.tokens)
        self._host_tokens = torch.zeros((max_batch,), dtype=torch.int32, pin_memory=on_card)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None   # the graph's output
        self.replays = 0
        if on_card:
            self._capture()

    def _body(self):
        return decode_body(self._serve, self.cfg.vocab_size, self.params, self.cache,
                           self.tokens, self.next_tokens)

    def _capture(self):
        """Warm up on the engine's own cache, reset its lengths to zero,
        then capture the body over the engine's buffers. The warm-up's
        writes need no undoing: every slot is empty, an empty slot's
        garbage is masked out, and ``_insert`` overwrites all of a slot's
        entries on admission. Both on one side stream of this engine: the
        decode kernel's split counters are kept per stream
        (kernels/decode_attention/ops.py), so the buffer baked into this
        graph is made by the warm-up, outside the graph."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._body()
            self.cache["len"].zero_()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits = self._body()

    def decode(self) -> torch.Tensor:
        """One decode step over the static buffers (``tokens`` in,
        ``next_tokens`` and the cache out): a graph replay on the card, the
        body eagerly elsewhere. Returns the logits."""
        if self.graph is None:
            return self._body()
        self.graph.replay()
        self.replays += 1
        return self.logits

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
                logits, pre_cache = self._prefill(self.params, batch, last)
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
        toks = self._host_tokens.numpy()
        toks[:] = 0
        for i in active:
            toks[i] = self.slots[i].out_tokens[-1]
        t0 = time.time()
        self.tokens.copy_(self._host_tokens, non_blocking=True)
        self.decode()
        nxt = self.next_tokens.tolist()     # the step's one sync
        dt = time.time() - t0
        self.iteration_log.append(("decode", len(active), dt))
        out = []
        now = time.time()
        for i in active:
            req = self.slots[i]
            req.out_tokens.append(nxt[i])
            req.token_times.append(now)
            done = len(req.out_tokens) - 1 >= req.max_new
            out.append((req.rid, nxt[i], done))
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
