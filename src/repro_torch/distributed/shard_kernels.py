"""The kernels' plain versions on DTensors, run by each rank on the shards
it holds, as a sharded kernel runs: the dry-run's attention and expert
products.

DTensor would run a plain version op by op, and its rules cannot take a
product batched over two sharded dims (the batch over "data" and the heads
over "model") in every release. Here each input is first laid out as the
kernel takes it (the batch as the activations have it, the query heads
over "model" where they divide it, the KV heads with them where theirs
do); each rank then runs the plain version on its shards, and the results
come back as DTensors. A rank whose query heads share KV heads it does not
hold alone takes those KV heads from a replica, and their gradients come
back as partial sums. Decode attention over a cache whose positions are
split over "model" (``kv_seq_shard``) runs as split-KV decode does: each
rank's (max, sum, output) over its positions, merged by collectives of
(B, H) and (B, H, D) values. The SSD scan and its backward run on each
rank's batch rows and heads. The grouped matmul and its gradients run on
the experts over "model" where their count divides 16 (EP, as
``models.mlp.moe_specs`` lays the weights out) and on the experts' hidden
dim over it otherwise (TP), with fsdp's weight shards gathered and the
capacity rows as split as they come; a sum over a split dim comes back
partial. Every such layout is fixed by the shapes and the mesh, so the
counts do not depend on the plans a DTensor release would choose.
Under ``per_shard()`` (the dry-run installs it), ``kernels.common.plain``
sends a call here when one of its arguments is a DTensor; plain tensors
among them are taken as replicated.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.kernels.common import NEG_INF, observe_plain
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import ref as ssd_ref
from repro_torch.kernels.moe_gmm import ref as gmm_ref


def _meta_stride(shape):
    return torch.empty(shape, device="meta").stride()


def _wrap(local, mesh, placements, shape):
    """A rank's result as a DTensor of the global ``shape``, contiguous as
    the kernel writes it."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=tuple(shape), stride=_meta_stride(shape))


def _mesh(*ts):
    return next(t.device_mesh for t in ts if sh.is_dtensor(t))


def _dtensors(mesh, *ts):
    """DTensors of ``ts``, a plain tensor taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    return [t if sh.is_dtensor(t) else
            DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for t in ts]


def _model_dims(mesh):
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n == "model" and mesh.size(i) > 1]


def _heads(q, k, head_dim_q: int, head_dim_k: int):
    """The kernel's layout of q and k/v: (q placements, kv placements, the
    KV heads of this rank's query heads (None: its k/v shards are them))."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh          # a DTensor (the runners make it one)
    batch = [p if p.is_shard(0) else Replicate() for p in q.placements]
    H, KH = q.shape[head_dim_q], k.shape[head_dim_k]
    qp, kp, sel = list(batch), list(batch), None
    for i in _model_dims(mesh):
        n = mesh.size(i)
        if H % n == 0:
            qp[i] = Shard(head_dim_q)
            if KH % n == 0:
                kp[i] = Shard(head_dim_k)
            else:
                hl = H // n
                first = mesh.get_local_rank(i) * hl
                sel = (first + torch.arange(hl)) // (H // KH)
    return qp, kp, sel


def mha_reference(fn, q, k, v, **kw):
    """Flash attention's forward on each rank's shards."""
    mesh = _mesh(q, k, v)
    q, k, v = _dtensors(mesh, q, k, v)
    qp, kp, sel = _heads(q, k, 2, 2)
    ql, kl, vl = (t.redistribute(mesh, p).to_local() for t, p in ((q, qp), (k, kp), (v, kp)))
    if sel is not None:
        kl, vl = (t.index_select(2, sel.to(t.device)) for t in (kl, vl))
    return _wrap(fn(ql, kl, vl, **kw), mesh, qp, q.shape)


def lse_reference(fn, q, k, **kw):
    """Each query row's log-sum-exp (B, H, Sq), on each rank's shards."""
    from torch.distributed.tensor import Shard

    mesh = _mesh(q, k)
    q, k = _dtensors(mesh, q, k)
    qp, kp, sel = _heads(q, k, 2, 2)
    ql, kl = q.redistribute(mesh, qp).to_local(), k.redistribute(mesh, kp).to_local()
    if sel is not None:
        kl = kl.index_select(2, sel.to(kl.device))
    lp = [Shard(1) if p.is_shard(2) else p for p in qp]
    B, Sq, H, _ = q.shape
    return _wrap(fn(ql, kl, **kw), mesh, lp, (B, H, Sq))


def mha_backward_reference(fn, q, k, v, dout, **kw):
    """Flash attention's (dq, dk, dv) on each rank's shards; dk and dv of KV
    heads taken from a replica come back as partial sums."""
    from torch.distributed.tensor import Partial

    mesh = _mesh(q, k, v, dout)
    q, k, v, dout = _dtensors(mesh, q, k, v, dout)
    qp, kp, sel = _heads(q, k, 2, 2)
    ql, kl, vl, gl = (t.redistribute(mesh, p).to_local()
                      for t, p in ((q, qp), (k, kp), (v, kp), (dout, qp)))
    if sel is not None:
        kl, vl = (t.index_select(2, sel.to(t.device)) for t in (kl, vl))
    dq, dk, dv = fn(ql, kl, vl, gl, **kw)
    if sel is not None:
        full = lambda d: torch.zeros((*d.shape[:2], k.shape[2], d.shape[3]), dtype=d.dtype,  # noqa: E731
                                     device=d.device).index_add_(2, sel.to(d.device), d)
        dk, dv = full(dk), full(dv)
        kp = [Partial() if p.is_shard(2) else p for p in qp]
    return (_wrap(dq, mesh, qp, q.shape), _wrap(dk, mesh, kp, k.shape),
            _wrap(dv, mesh, kp, v.shape))


def decode_attention_reference(fn, q, k_cache, v_cache, lengths, *, scale=None, window=0):
    """Decode attention on each rank's shards: the cache's slots as it lays
    them out; its heads over "model", or its positions, whose (max, sum,
    output) the ranks merge."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = _mesh(q, k_cache, v_cache, lengths)
    q, k_cache, v_cache, lengths = _dtensors(mesh, q, k_cache, v_cache, lengths)
    batch = [p if p.is_shard(0) else Replicate() for p in k_cache.placements]
    seq = [i for i, p in enumerate(k_cache.placements) if p.is_shard(1)]
    heads = [i for i, p in enumerate(k_cache.placements) if p.is_shard(2)]
    qp, kp = list(batch), list(batch)
    for i in heads:
        qp[i] = kp[i] = Shard(1)
        kp[i] = Shard(2)
    for i in seq:
        kp[i] = Shard(1)
    ql, ll = q.redistribute(mesh, qp).to_local(), lengths.redistribute(mesh, batch).to_local()
    kl, vl = (t.redistribute(mesh, kp).to_local() for t in (k_cache, v_cache))
    if not seq:
        return _wrap(fn(ql, kl, vl, ll, scale=scale, window=window), mesh, qp, q.shape)
    # split-KV over the ranks that hold the positions: this rank's keys
    # [first, first + S_loc)
    first = 0
    for i in seq:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    S = kl.shape[1]
    first *= S
    _, H, D = ql.shape
    g = H // kl.shape[2]
    qf = ql.float() * (scale if scale is not None else D ** -0.5)
    kf, vf = (t.float().repeat_interleave(g, dim=2) for t in (kl, vl))
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    pos = first + torch.arange(S, device=ql.device)[None, None, :]
    lens = ll[:, None, None]
    keep = pos < lens
    if window and window > 0:
        keep &= pos > (lens - 1 - window)
    rows = [p for p in qp]

    def merge(t, kind):
        part = [Partial(kind) if i in seq else p for i, p in enumerate(rows)]
        return _wrap(t, mesh, part, (q.shape[0], *t.shape[1:])).redistribute(mesh, rows).to_local()
    logits = torch.where(keep, logits, NEG_INF)
    m = merge(logits.amax(dim=-1), "max")                                       # (B, H)
    # as the plain version: a row with no key kept weighs every position alike
    p = torch.exp(logits - m[..., None])
    den = merge(p.sum(-1), "sum")
    num = merge(torch.einsum("bhs,bshd->bhd", p, vf), "sum")
    return _wrap((num / (den[..., None] + 1e-30)).to(q.dtype), mesh, rows, q.shape)


def _experts(x, E: int, f: int):
    """The grouped matmul's layout per mesh dim: "ep" (the experts), "tp"
    (the hidden dim f), "rows" (x's capacity rows, where they come split)
    or None (replicated)."""
    from repro_torch.models.mlp import PRODUCTION_TP
    mesh, out = x.device_mesh, []
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if n == 1:
            out.append(None)
        elif name == "model":
            out.append("ep" if E % PRODUCTION_TP == 0 and E % n == 0 else
                       "tp" if f % n == 0 else None)
        else:
            out.append("rows" if x.placements[i].is_shard(1) and x.shape[1] % n == 0 else None)
    return out


def _at(layout, **dims):
    """Placements: ``dims`` maps a role of ``layout`` ("ep", "tp", "rows";
    "batch", "heads") to a tensor dim to shard (or "partial"); other roles
    replicate."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for role in layout:
        d = dims.get(role)
        out.append(Partial() if d == "partial" else Shard(d) if d is not None else Replicate())
    return out


def gmm_reference(fn, x, w):
    """(E, C, d) x (E, d, f) on each rank's experts or hidden slice."""
    mesh = _mesh(x, w)
    x, w = _dtensors(mesh, x, w)
    lay = _experts(x, x.shape[0], w.shape[2])
    xl = x.redistribute(mesh, _at(lay, ep=0, rows=1)).to_local()
    wl = w.redistribute(mesh, _at(lay, ep=0, tp=2)).to_local()
    return _wrap(fn(xl, wl), mesh, _at(lay, ep=0, rows=1, tp=2),
                 (*x.shape[:2], w.shape[2]))


def gmm_dx_reference(fn, g, w):
    """dx = g w^T; a sum over a split hidden dim comes back partial."""
    mesh = _mesh(g, w)
    g, w = _dtensors(mesh, g, w)
    lay = _experts(g, g.shape[0], w.shape[2])
    gl = g.redistribute(mesh, _at(lay, ep=0, rows=1, tp=2)).to_local()
    wl = w.redistribute(mesh, _at(lay, ep=0, tp=2)).to_local()
    return _wrap(fn(gl, wl), mesh, _at(lay, ep=0, rows=1, tp="partial"),
                 (*g.shape[:2], w.shape[1]))


def gmm_dw_reference(fn, x, g):
    """dw = x^T g; a sum over split capacity rows comes back partial."""
    mesh = _mesh(x, g)
    x, g = _dtensors(mesh, x, g)
    lay = _experts(x, x.shape[0], g.shape[2])
    xl = x.redistribute(mesh, _at(lay, ep=0, rows=1)).to_local()
    gl = g.redistribute(mesh, _at(lay, ep=0, rows=1, tp=2)).to_local()
    return _wrap(fn(xl, gl), mesh, _at(lay, ep=0, tp=2, rows="partial"),
                 (x.shape[0], x.shape[2], g.shape[2]))


def _ssd_layout(x):
    """The SSD scan's layout per mesh dim: "batch" (x's batch, as it comes
    split), "heads" (the heads over "model", where they divide it) or None."""
    mesh, H, out = x.device_mesh, x.shape[2], []
    for i, p in enumerate(x.placements):
        n = mesh.size(i)
        out.append("batch" if p.is_shard(0) else
                   "heads" if i in _model_dims(mesh) and H % n == 0 else None)
    return out


def ssd_chunked_reference(fn, x, dt, A, Bmat, Cmat, D, init_state=None):
    """The SSD scan on each rank's batch rows and heads: (y, final state)."""
    mesh = _mesh(x, dt, A, Bmat, Cmat, D)
    x, dt, A, Bmat, Cmat, D = _dtensors(mesh, x, dt, A, Bmat, Cmat, D)
    lay = _ssd_layout(x)
    xl, dtl = (t.redistribute(mesh, _at(lay, batch=0, heads=2)).to_local() for t in (x, dt))
    Al, Dl = (t.redistribute(mesh, _at(lay, heads=0)).to_local() for t in (A, D))
    Bl, Cl = (t.redistribute(mesh, _at(lay, batch=0)).to_local() for t in (Bmat, Cmat))
    sp = _at(lay, batch=0, heads=1)
    il = None if init_state is None else \
        _dtensors(mesh, init_state)[0].redistribute(mesh, sp).to_local()
    y, state = fn(xl, dtl, Al, Bl, Cl, Dl, il)
    B_, _, H, P = x.shape
    return (_wrap(y, mesh, _at(lay, batch=0, heads=2), x.shape),
            _wrap(state, mesh, sp, (B_, H, P, Bmat.shape[-1])))


def ssd_backward_reference(fn, x, dt, A, Bmat, Cmat, D, init_state, dy):
    """The SSD scan's seven gradients on each rank's batch rows and heads;
    dA and dD (sums over the batch) and dB and dC (sums over the heads)
    come back partial."""
    mesh = _mesh(x, dt, A, Bmat, Cmat, D, dy)
    x, dt, A, Bmat, Cmat, D, dy = _dtensors(mesh, x, dt, A, Bmat, Cmat, D, dy)
    lay = _ssd_layout(x)
    xl, dtl, dyl = (t.redistribute(mesh, _at(lay, batch=0, heads=2)).to_local()
                    for t in (x, dt, dy))
    Al, Dl = (t.redistribute(mesh, _at(lay, heads=0)).to_local() for t in (A, D))
    Bl, Cl = (t.redistribute(mesh, _at(lay, batch=0)).to_local() for t in (Bmat, Cmat))
    sp = _at(lay, batch=0, heads=1)
    il = None if init_state is None else \
        _dtensors(mesh, init_state)[0].redistribute(mesh, sp).to_local()
    dx, ddt, dA, dB, dC, dD, dinit = fn(xl, dtl, Al, Bl, Cl, Dl, il, dyl)
    B_, _, H, P = x.shape
    per_head = _at(lay, heads=0, batch="partial")
    per_row = _at(lay, batch=0, heads="partial")
    return (_wrap(dx, mesh, _at(lay, batch=0, heads=2), x.shape),
            _wrap(ddt, mesh, _at(lay, batch=0, heads=2), dt.shape),
            _wrap(dA, mesh, per_head, A.shape), _wrap(dB, mesh, per_row, Bmat.shape),
            _wrap(dC, mesh, per_row, Cmat.shape), _wrap(dD, mesh, per_head, D.shape),
            _wrap(dinit, mesh, sp, (B_, H, P, Bmat.shape[-1])))


RUNNERS = {fa_ref.mha_reference: mha_reference, fa_ref.lse_reference: lse_reference,
           fa_ref.mha_backward_reference: mha_backward_reference,
           da_ref.decode_attention_reference: decode_attention_reference,
           gmm_ref.gmm_reference: gmm_reference, gmm_ref.gmm_dx_reference: gmm_dx_reference,
           gmm_ref.gmm_dw_reference: gmm_dw_reference,
           ssd_ref.ssd_chunked_reference: ssd_chunked_reference,
           ssd_ref.ssd_backward_reference: ssd_backward_reference}


@contextlib.contextmanager
def per_shard():
    """For this thread, run every plain version that gets a DTensor among
    its arguments on each rank's shards, by its runner above (a plain
    version without one raises a KeyError); other calls go on as they
    were."""
    def obs(fn, args, kwargs):
        if any(sh.is_dtensor(a) for a in args):
            fn = functools.partial(RUNNERS[fn], fn)
        return prev(fn, args, kwargs) if prev is not None else fn(*args, **kwargs)

    prev = observe_plain(obs)
    try:
        yield
    finally:
        observe_plain(prev)
