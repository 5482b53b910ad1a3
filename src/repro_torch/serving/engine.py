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

JaxEngine also compiles its prefill, once per shape (the bucket, or the
exact length of a recurrent prompt), and its slot insert, the cache
donated. Their counterpart is one CUDA graph per prefill shape of
``prefill_body`` (the prefill step, the greedy first token, the insert of
the prefill cache into the slot IN PLACE, the slot a device index),
captured at the shape's first admission and replayed at every later one.
On the CPU both bodies run eagerly over the same buffers.
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


def insert_slot(cache, pre_cache, slot, length):
    """Copy every entry of a one-sequence prefill cache into the slot
    ``slot`` ((1,) int64 on the cache's device) of ``cache`` IN PLACE: a
    per-slot state (SSM, conv tail, xLSTM cells) whole; K/V up to the
    prefill's n positions, zeros from there to max_len (what the slot held
    before must read as zeros); ``len[slot] = length``. The slot is a device
    index, so one captured graph serves every slot."""
    for name, buf in cache.items():
        src = pre_cache[name]
        if name == "len":
            buf.index_copy_(0, slot, length.to(buf.dtype))
        elif name in ("k", "v"):
            n = src.shape[2]
            buf[:, :, :n].index_copy_(1, slot, src.to(buf.dtype))
            buf[:, :, n:].index_fill_(1, slot, 0)
        else:
            buf.index_copy_(1, slot, src.to(buf.dtype))


def prefill_body(prefill_step, vocab_size, params, cache, tokens, last, slot, length,
                 first, logits_out):
    """One admission over static buffers: ``prefill_step`` of the token row
    ``tokens`` (1, n) with the logits of position ``last`` (1,), the greedy
    first token into ``first`` (1,) and the logits into ``logits_out``,
    and the prefill cache inserted into the slot ``slot`` (1,) with length
    ``length`` (1,) (``insert_slot``). No host read of device data: the
    engine captures it in a CUDA graph per shape. Returns the logits."""
    with torch.no_grad():
        logits, pre = prefill_step(params, {"tokens": tokens}, last)
        first.copy_(torch.argmax(logits[:, :vocab_size], -1))
        logits_out.copy_(logits)
        insert_slot(cache, pre, slot, length)
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
    nothing a stream capture forbids. The prefill of each shape is captured
    the same way at its first admission (``prefill_graphs``, keyed by the
    shape; the warm-up writes the slot being admitted) and replayed at
    every later one (``prefill_replays``); all prefill graphs share one
    memory pool, apart from the decode graph's. A capture that fails
    raises: there is no eager fallback on the card. (Served params are
    plain tensors, under a mesh too; no kernel takes a DTensor on the
    card.) ``iteration_log``'s decode rows time the whole step, replay or
    eager: writing the tokens, the step, and reading the next tokens back;
    its prefill rows time an admission from the token upload to the first
    token read back (a shape's first includes its warm-up and capture).
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
        # prefill: per shape n a device row (last, slot, length, n tokens),
        # uploaded from a pinned host row; the first token and the logits
        # land in buffers of the engine's own, outside any graph's pool
        self._prefill_in: Dict[int, torch.Tensor] = {}
        self._prefill_host = torch.zeros((3 + max_len,), dtype=torch.int64, pin_memory=on_card)
        emb = params["emb"]["embed"]
        self.first_token = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.prefill_logits = torch.zeros((1, emb.shape[0]), dtype=emb.dtype, device=self.device)
        self.prefill_graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.prefill_replays = 0
        if on_card:
            self._stream = torch.cuda.Stream(self.device)
            self._prefill_pool = torch.cuda.graph_pool_handle()
            self._capture()

    def _body(self):
        return decode_body(self._serve, self.cfg.vocab_size, self.params, self.cache,
                           self.tokens, self.next_tokens)

    def _capture(self):
        """Warm up on the engine's own cache, reset its lengths to zero,
        then capture the body over the engine's buffers. The warm-up's
        writes need no undoing: every slot is empty, an empty slot's
        garbage is masked out, and ``insert_slot`` overwrites all of a
        slot's entries on admission. Both on one side stream of this engine
        (the prefill captures' too): the decode kernel's split counters are
        kept per stream (kernels/decode_attention/ops.py), so the buffer
        baked into this graph is made by the warm-up, outside the graph."""
        stream = self._stream
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

    def _prefill_args(self, n: int):
        buf = self._prefill_in[n]
        return (self._prefill, self.cfg.vocab_size, self.params, self.cache,
                buf[3:].view(1, n), buf[0:1], buf[1:2], buf[2:3], self.first_token,
                self.prefill_logits)

    def _capture_prefill(self, n: int):
        """The first admission of shape ``n`` on the card, in the stream
        order of ``_capture``: a warm-up of the body on the side stream
        (into the free slot being admitted), the capture into the prefill
        pool, then the graph's first replay on the current stream."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            prefill_body(*self._prefill_args(n))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._prefill_pool, stream=self._stream):
            prefill_body(*self._prefill_args(n))
        current.wait_stream(self._stream)
        graph.replay()
        self.prefill_graphs[n] = graph

    def prefill(self, n: int) -> torch.Tensor:
        """One admission's prefill of shape ``n`` over the static buffers
        (its uploaded row in; the slot's cache, ``first_token`` and
        ``prefill_logits`` out): on the card a replay of that shape's graph,
        captured at its first use; the body eagerly elsewhere. Returns
        ``prefill_logits``."""
        if self.device.type != "cuda":
            prefill_body(*self._prefill_args(n))
        elif n in self.prefill_graphs:
            self.prefill_graphs[n].replay()
            self.prefill_replays += 1
        else:
            self._capture_prefill(n)
        return self.prefill_logits

    def _load_prompt(self, slot: int, prompt: np.ndarray) -> int:
        """Write an admission's row on the host: the last position, the
        slot, the length, and the prompt zero-padded to its shape (written
        whole: a longer prompt's tokens never reach the cache). Returns the
        shape: the bucket for attention families, whose pads the cache's
        ``len`` masks; the exact length for recurrent ones, whose state
        would absorb pads."""
        S = len(prompt)
        n = S if self.cfg.is_recurrent else min(_bucket(S), self.max_len)
        if 3 + n > self._prefill_host.numel():     # a recurrent prompt past max_len
            self._prefill_host = torch.zeros((3 + n,), dtype=torch.int64,
                                             pin_memory=self.device.type == "cuda")
        if n not in self._prefill_in:
            self._prefill_in[n] = torch.zeros((3 + n,), dtype=torch.int64, device=self.device)
        row = self._prefill_host.numpy()
        row[:3] = (S - 1, slot, S)
        row[3:3 + n] = 0
        row[3:3 + S] = prompt
        return n

    def _prefill_into(self, n: int) -> int:
        """Upload the row of shape ``n``, run its prefill, and read the first
        token back: the admission's one sync, which also orders the next
        admission's write of the pinned row after this upload."""
        self._prefill_in[n].copy_(self._prefill_host[:3 + n], non_blocking=True)
        self.prefill(n)
        return int(self.first_token)

    def submit(self, rid: int, prompt: np.ndarray, max_new: int):
        """Queue a request. A prompt must hold at least one token, and, where
        the cache holds positions (K/V of max_len), at most max_len: longer
        ones are turned away here, before any device work."""
        prompt = np.asarray(prompt)
        S, positions = len(prompt), "k" in self.cache
        if S < 1 or (positions and S > self.max_len):
            raise ValueError(f"request {rid}: a prompt of {S} tokens; this engine takes at "
                             f"least 1" + (f" and at most max_len={self.max_len}"
                                           if positions else ""))
        self.queue.append(EngineRequest(rid, prompt, max_new, submitted=time.time()))

    def _admit(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                n = self._load_prompt(i, req.prompt)
                t0 = time.time()
                first = self._prefill_into(n)
                req.prefill_done = time.time()
                req.out_tokens.append(first)
                self.iteration_log.append(("prefill", n, req.prefill_done - t0))
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
