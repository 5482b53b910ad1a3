"""The SSD scan's chunked backward on the CPU: its plain counterpart
(``ref.ssd_backward_chunk_parallel``, the decomposition the backward
kernels run: start states forward over the chunks, adjoints backward, then
every chunk at once with dB / dC summed over groups of heads) against
``jax.vjp`` of the reference's token scan (``_ssd_bwd`` itself), all seven
gradients, fp32 at atol / rtol 1e-4, the reference's SSD tolerance
(tests/test_kernels.py); and the host-side launch plan (``ops.bwd_plan``:
heads per chunk block, grids, workspace bytes) and route (tensor cores or
CUDA cores) from shapes and layouts alone. The CUDA kernels themselves are
held against the plain backward on the card by chip_smoke.py."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ref as jms_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")
# (B, S, H, P, N, init, heads per group): tests/test_kernels.py's SSD sweep,
# ragged S (100 = 64 + 36, 200 = 3 x 64 + 8), one token, each with and
# without an initial state, and a head the two-sweep kernel refused in fp32
# (P = 64, N = 128) with an initial state over a ragged last chunk
CASES = [(B, S, H, P, N, init, hg)
         for B, S, H, P, N, hg in [(1, 64, 2, 16, 16, 1), (2, 128, 3, 16, 32, 2),
                                   (1, 128, 1, 64, 64, 1), (2, 100, 2, 8, 16, 2),
                                   (2, 200, 2, 8, 16, 1), (2, 1, 2, 8, 16, 2)]
         for init in (False, True)] + [(1, 130, 2, 64, 128, True, 1)]


@lru_cache(None)
def _case(B, S, H, P, N, init):
    """numpy inputs (the reference's SSD sweep distributions), a cotangent,
    and jax.vjp of the token scan's y at them (dinit None without init)."""
    rng = np.random.default_rng(1000 + B * 7 + S * 13 + H * 17 + P * 19 + N * 23 + init)
    f = np.float32
    args = (rng.normal(size=(B, S, H, P)).astype(f), rng.uniform(0.001, 0.1, (B, S, H)).astype(f),
            -rng.uniform(0.5, 2.0, (H,)).astype(f), rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f), rng.normal(size=(H,)).astype(f),
            rng.normal(size=(B, H, P, N)).astype(f) if init else None)
    dy = rng.normal(size=(B, S, H, P)).astype(f)
    _, vjp = jax.vjp(lambda *a: jms_ref.ssd_reference(*a)[0], *args)
    want = tuple(None if g is None else np.asarray(g) for g in vjp(jnp.asarray(dy)))
    return args, dy, want


# At P = 64, N = 128 ddt's terms are hundreds where ddt is near 1: the
# reference's fp32 VJP is itself 0.95 of the 1e-4 tolerance away from the
# fp64 result in ddt there (and the fp32 decomposition 0.33), so the two
# fp32 results differ by 1.2 of it. That case holds the decomposition in
# fp64 to the reference's VJP (the algebra), and in fp32 to the fp64 result
# of the plain sequential backward (chip_smoke.py's criterion for the fp32
# kernel), both at 1e-4.
WIDE = {(1, 130, 2, 64, 128, True)}


def _check(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,init,hg", CASES)
def test_chunk_parallel_backward_matches_jax_vjp(B, S, H, P, N, init, hg):
    """The kernels' decomposition, in plain torch, against the reference's
    custom VJP rule."""
    args, dy, want = _case(B, S, H, P, N, init)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    tdy = torch.from_numpy(dy)
    got = ms_ref.ssd_backward_chunk_parallel(*targs, tdy, heads_per_group=hg)
    assert got[6].shape == (B, H, P, N) and all(g.dtype == torch.float32 for g in got)
    if (B, S, H, P, N, init) not in WIDE:
        _check(got, want)
        return
    wide = [None if t is None else t.double() for t in targs]
    _check(ms_ref.ssd_backward_chunk_parallel(*wide, tdy.double(), heads_per_group=hg), want)
    exact = ms_ref.ssd_backward_reference(*wide, tdy.double())
    _check(got, [w.numpy() for w in exact])


def test_chunk_parallel_backward_is_the_sequential_one_in_fp64():
    """In fp64 the decomposition and the sequential reverse pass (the
    oracle on the card) agree to rounding, the group sums included."""
    rng = np.random.default_rng(7)
    B, S, H, P, N = 2, 150, 5, 8, 16
    d = torch.float64
    x = torch.from_numpy(rng.normal(size=(B, S, H, P))).to(d)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H))).to(d)
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H)).to(d)
    Bm, Cm = (torch.from_numpy(rng.normal(size=(B, S, N))).to(d) for _ in range(2))
    D = torch.from_numpy(rng.normal(size=H)).to(d)
    s0 = torch.from_numpy(rng.normal(size=(B, H, P, N))).to(d)
    dy = torch.from_numpy(rng.normal(size=(B, S, H, P))).to(d)
    want = ms_ref.ssd_backward_reference(x, dt, A, Bm, Cm, D, s0, dy)
    for hg in (1, 2, 5):
        got = ms_ref.ssd_backward_chunk_parallel(x, dt, A, Bm, Cm, D, s0, dy, heads_per_group=hg)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-10, msg=name)


# (B, S, H, P, N, dtype, variant, sms, init) -> (heads per group, groups,
# states grid, chunk grid, state bytes, state bytes written, dB / dC
# partial bytes, dA / dD partial bytes), worked out by hand
PLANS = [
    # zamba2-1.2b's train step, bf16 on the tensor cores: 8 heads a group,
    # 4 x 8 x 8 = 256 chunk blocks for 132 SMs x 2; S0 and G of 7 of 8
    # chunks written, two bf16 planes of 64 x 64 each
    ((4, 512, 64, 64, 64, torch.bfloat16, "mma", 132, False),
     (8, 8, (2, 64, 4), (8, 8, 4), 2 * 4 * 64 * 8 * 64 * 64 * 4, 4 * 64 * 14 * 64 * 64 * 4,
      2 * 8 * 4 * 512 * 64 * 4, 4 * 8 * 64 * 2 * 4)),
    # zamba2's card parity (B=2, S=200) in fp32, on the CUDA cores in fp64:
    # one block an SM, 16 groups of 4 heads; 32-row slices of P
    ((2, 200, 64, 64, 64, torch.float32, "fma", 132, False),
     (4, 16, (4, 64, 2), (4, 16, 2), 2 * 2 * 64 * 4 * 64 * 64 * 8, 2 * 64 * 6 * 64 * 64 * 8,
      2 * 16 * 2 * 200 * 64 * 4, 2 * 4 * 64 * 2 * 4)),
    # a head the two-sweep kernel refused in bf16 (P = N = 128), one chunk, an
    # initial state: S0 of chunk 0 written, P in two 64-row tiles
    ((1, 63, 2, 128, 128, torch.bfloat16, "mma", 132, True),
     (1, 2, (4, 2, 1), (1, 2, 1), 2 * 2 * 128 * 128 * 4, 2 * 128 * 128 * 4,
      2 * 2 * 63 * 128 * 4, 2 * 2 * 4)),
    # P = 200 pads to 256 rows of the tensor cores' tiles
    ((1, 1000, 1, 200, 64, torch.bfloat16, "mma", 132, True),
     (1, 1, (8, 1, 1), (16, 1, 1), 2 * 16 * 256 * 64 * 4, 31 * 256 * 64 * 4,
      2 * 1000 * 64 * 4, 16 * 2 * 4)),
    # more (b, chunk) pairs than SM slots: every head in one group
    ((64, 1024, 4, 16, 16, torch.bfloat16, "mma", 132, False),
     (4, 1, (2, 4, 64), (16, 1, 64), 2 * 64 * 4 * 16 * 64 * 16 * 4,
      64 * 4 * 30 * 64 * 16 * 4, 2 * 64 * 1024 * 16 * 4, 64 * 16 * 4 * 8)),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_bwd_plan_from_shapes(shape, want):
    B, S, H, P, N, dtype, variant, sms, init = shape
    plan = ms_ops.bwd_plan(B, S, H, P, N, dtype, variant, sms, init=init)
    got = (plan.heads_per_group, plan.groups, plan.states_grid, plan.chunk_grid,
           plan.state_bytes, plan.state_traffic, plan.dbc_bytes, plan.ad_bytes)
    assert got == want
    assert plan.chunks == cdiv(S, 64) and plan.variant == variant
    assert plan.workspace_bytes == plan.state_bytes + plan.dbc_bytes + plan.ad_bytes


@pytest.mark.parametrize("B,S,H", [(1, 1, 1), (1, 64, 2), (3, 1000, 64), (4, 512, 64),
                                   (2, 200, 64), (8, 4096, 24), (1, 100000, 3)])
@pytest.mark.parametrize("variant", ["mma", "fma"])
def test_bwd_plan_fills_one_wave_and_covers_every_head(B, S, H, variant):
    """Groups x heads per group cover the heads with no empty group, and the
    chunk blocks fit one wave of the SMs' slots unless the (b, chunk) pairs
    alone exceed it; the group count follows the shapes only."""
    sms = 132
    plan = ms_ops.bwd_plan(B, S, H, 64, 64, torch.bfloat16, variant, sms)
    hg, groups = plan.heads_per_group, plan.groups
    assert hg >= 1 and groups * hg >= H and (groups - 1) * hg < H
    blocks = B * plan.chunks * groups
    assert blocks <= max(sms * plan.blocks_per_sm, B * plan.chunks)
    assert plan.chunk_grid == (plan.chunks, groups, B)
    again = ms_ops.bwd_plan(B, S, H, 64, 64, torch.bfloat16, variant, sms)
    assert again == plan


@pytest.mark.parametrize("N", ms_ops.STATE_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_chunk_block_fits_an_sm(N, dtype):
    """Every instance of the chunk kernel takes at most 227 KB of shared
    memory; the tensor-core one runs two blocks an SM up to N = 64."""
    for variant in ("mma", "fma") if dtype == torch.bfloat16 else ("fma",):
        smem = ms_ops.chunk_smem_bytes(N, variant, dtype)
        assert smem <= 232448
        plan = ms_ops.bwd_plan(1, 64, 1, 64, N, dtype, variant, 132)
        assert plan.blocks_per_sm == (2 if variant == "mma" and N <= 64 else 1)


def _conv_slices(B, S, H, P, N, dtype, offset=0):
    """x, B and C as column slices of one conv buffer whose rows start
    ``offset`` elements into a wider allocation (row strides unchanged)."""
    W = H * P + 2 * N
    buf = torch.randn(B, S, W + 8).to(dtype)[..., offset:offset + W]
    return (buf[..., :H * P].view(B, S, H, P), buf[..., H * P:H * P + N], buf[..., H * P + N:])


@pytest.mark.parametrize("what,dtype,P,offset,want", [
    ("zamba2's conv-buffer slices", torch.bfloat16, 64, 0, True),
    ("fp32 always on the CUDA cores", torch.float32, 64, 0, False),
    ("P not a multiple of 8", torch.bfloat16, 12, 0, False),
    ("slices 8 bytes off a 16-byte boundary", torch.bfloat16, 64, 4, False),
])
def test_bwd_route_follows_dtype_and_layout(what, dtype, P, offset, want):
    x, Bm, Cm = _conv_slices(2, 8, 2, P, 16, dtype, offset)
    dy = torch.randn(x.shape).to(dtype)
    if offset:   # torch's CPU allocations are 64-byte aligned: the slices are not
        assert x.data_ptr() % 16 == 8
    assert ms_ops.bwd_takes_mma(x, Bm, Cm, dy) is want, what
