"""The gradients of the port's kernel entry points on the CPU (their plain
versions, through the same ``torch.autograd.Function``s the card runs)
against the JAX package: flash attention against ``jax.grad`` of
``flash_attention(impl="pallas_interpret")`` (whose custom VJP recomputes
through the oracle), atol / rtol 1e-4 as the reference's own flash gradient
check (tests/test_kernels.py); the grouped matmul against ``jax.grad`` of
``grouped_matmul(impl="pallas_interpret")``, atol 1e-5 as its gradient
check, with rtol 1e-5 for the larger sums (up to 264 terms of randn
products: gradients near 20, whose fp32 ulp is 2e-6). The plain LSE against a float64 logsumexp, 1e-5. The CUDA kernels
are held against the same plain versions on the card by chip_smoke.py; the
shapes here include those whose C, d and f fall past the card kernels' tile
edges (the gradients' GEMM: 128 x 128 output tiles, K in steps of 64) and
qwen2-1.5b's 6 query heads per KV head at D = 128.
The SSD scan's gradient: the plain chunked reverse pass
(``ssd_backward_reference``, the algorithm of the backward kernel) and the
port's autograd through ``ssd_scan`` against ``jax.vjp`` of the reference's
token scan (``_ssd_bwd`` itself), all seven gradients, fp32 at atol / rtol
1e-4, the reference's SSD tolerance (tests/test_kernels.py), at that test's
shapes, at ragged S (100 and 200: a padded last chunk), at S = 1, with and
without an initial state.
Also: a CUDA-routed decode attention raises under grad (the reference has
no VJP for it), and so does a CUDA-routed SSD scan asked for its final
state (the reference differentiates y only); a CUDA-routed SSD scan under
grad hands its very inputs and the cotangent to the backward kernel's entry
point; the CUDA-routed gmm gradients hand the operands to the kernel as they
lie (no transposed copy); the flash backward's split of the query heads is a
function of the shapes only."""
import inspect
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.mamba_scan import ref as jms_ref
from repro.kernels.moe_gmm import ops as jgmm_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops


GMM_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


# (B, Sq, Sk, H, KH, D, causal, window): causal, window, GQA, Sq < Sk, no
# mask, D 32, 64 and 128, qwen2-1.5b's G = 6 query heads per KV head
# (shapes the interpret-mode kernel's blocks divide)
FLASH_CASES = [(1, 128, 128, 2, 2, 32, True, 0), (2, 128, 128, 4, 2, 64, True, 48),
               (1, 64, 128, 6, 2, 32, True, 0), (1, 64, 128, 4, 1, 64, True, 32),
               (2, 128, 128, 4, 4, 64, False, 0), (1, 64, 128, 2, 1, 32, False, 0),
               (1, 128, 128, 12, 2, 128, True, 0), (2, 64, 64, 6, 1, 64, True, 16),
               (1, 64, 128, 6, 1, 128, True, 0)]


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", FLASH_CASES)
def test_flash_grad_matches_jax(B, Sq, Sk, H, KH, D, causal, window):
    rng = np.random.default_rng(hash((B, Sq, Sk, H, KH, D, causal, window)) % 2**31)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)))
    dout = rng.standard_normal((B, Sq, H, D)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jfa_ops.flash_attention(q_, k_, v_, causal=causal, window=window,
                                      impl="pallas_interpret")
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(dout))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")
    # the wrapper's backward is the plain backward on the CPU
    direct = fa_ref.mha_backward_reference(tq, tk, tv, _t(dout), causal=causal, window=window)
    for a, b in zip(got, direct):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("Sq,Sk,causal,window", [(40, 40, True, 0), (40, 70, True, 16),
                                                  (33, 50, False, 0), (50, 20, False, 8)])
def test_plain_lse_matches_logsumexp(Sq, Sk, causal, window):
    rng = np.random.default_rng(7)
    B, H, KH, D = 2, 6, 3, 32
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KH, D)).astype(np.float32)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64) * D ** -0.5,
                  np.repeat(k, H // KH, axis=2).astype(np.float64))
    qp, kp = np.arange(Sq)[:, None] + (Sk - Sq), np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    s = np.where(keep, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    got = fa_ref.lse_reference(_t(q), _t(k), causal=causal, window=window)
    assert got.shape == (B, H, Sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_flash_refuses_a_causal_backward_with_queries_past_the_keys():
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    kv = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="backward"):
        fa_ops.flash_attention(q, kv, kv)
    with torch.no_grad():                        # the forward alone still runs
        assert fa_ops.flash_attention(q, kv, kv).shape == q.shape


# the repo's gradient-check shapes, then shapes past the gradients' GEMM
# tile edges: C = 130 and 200 past 128 rows of dx and past 2 and 3 K steps
# of 64 in dw; d = 136 and 264 and f = 72 and 136 past 128 and 256 columns
# and past the K steps of dx
@pytest.mark.parametrize("E,C,d,f", [(2, 16, 8, 12), (3, 17, 24, 40), (4, 64, 96, 160),
                                     (2, 130, 136, 72), (1, 200, 264, 136)])
def test_gmm_grad_matches_jax(E, C, d, f):
    rng = np.random.default_rng(E * 1000 + C)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    g = rng.standard_normal((E, C, f)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jgmm_ops.grouped_matmul(
        a, b, impl="pallas_interpret") * g), argnums=(0, 1))(x, w)
    tx, tw = _t(x, True), _t(w, True)
    got = torch.autograd.grad(gmm_ops.grouped_matmul(tx, tw), (tx, tw), _t(g))
    for name, a, b in zip(("dx", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GMM_TOL, err_msg=name)
    # the gradient entry points on their own
    np.testing.assert_allclose(gmm_ops.grouped_matmul_dx(_t(g), _t(w)).numpy(),
                               np.asarray(want[0]), **GMM_TOL)
    np.testing.assert_allclose(gmm_ops.grouped_matmul_dw(_t(x), _t(g)).numpy(),
                               np.asarray(want[1]), **GMM_TOL)


def test_cuda_gmm_gradients_read_the_operands_as_they_lie(monkeypatch):
    """On the card dx = g w^T is the GEMM's "nt" layout of g and w, and
    dw = x^T g its "tn" layout of x and g: the very tensors, no transposed
    copy; (M, N, K) = (C, d, f) and (d, f, C)."""
    E, C, d, f = 2, 5, 8, 16
    x, w, g = torch.randn(E, C, d), torch.randn(E, d, f), torch.randn(E, C, f)
    calls = []

    def gemm(a, b, layout, M, N, K):
        calls.append((a, b, layout, M, N, K))
        return torch.zeros(E, M, N)

    _cuda_route(monkeypatch, gmm_ops)
    monkeypatch.setattr(gmm_ops, "_gemm", gemm)
    assert gmm_ops.grouped_matmul_dx(g, w).shape == (E, C, d)
    assert gmm_ops.grouped_matmul_dw(x, g).shape == (E, d, f)
    (a, b, *rest), (a2, b2, *rest2) = calls
    assert a is g and b is w and rest == ["nt", C, d, f]
    assert a2 is x and b2 is g and rest2 == ["tn", d, f, C]


@pytest.mark.parametrize("B,Sk,KH,G", [(4, 512, 2, 6), (2, 512, 8, 3), (2, 512, 2, 16),
                                       (2, 100, 2, 6), (1, 1, 1, 12), (8, 1500, 8, 1),
                                       (64, 4096, 8, 4)])
def test_flash_bwd_split_rule(B, Sk, KH, G):
    """The dk/dv kernel's split of the G query heads of a KV head: a divisor
    of G, the fewest that give each of the card's SMs two blocks (G where
    none does), from the shapes and the SM count only (the caller passes the
    card's; 132 on an H100 SXM)."""
    params = inspect.signature(fa_ops.dkdv_splits).parameters
    assert list(params) == ["B", "Sk", "KH", "G", "sms"]
    n = fa_ops.dkdv_splits(B, Sk, KH, G, 132)
    blocks = -(-Sk // fa_ops.DKDV_KEYS) * KH * B
    assert G % n == 0
    assert blocks * n >= 2 * 132 or n == G
    assert all(G % m or blocks * m < 2 * 132 for m in range(1, n))


def test_flash_bwd_split_rule_at_the_train_shapes():
    """qwen2-1.5b (B=4, S=512, KH=2, G=6) takes 6 parts, granite-moe-3b-a800m
    (B=2, KH=8, G=3) 3, glm4-9b's G=16 at B=2 all 16; at B x S = 8 x 4096
    granite needs none."""
    assert [fa_ops.dkdv_splits(B, S, KH, G, 132) for B, S, KH, G in
            ((4, 512, 2, 6), (2, 512, 8, 3), (2, 512, 2, 16), (8, 4096, 8, 3))] == [6, 3, 16, 1]


@pytest.mark.parametrize("C,want", [(1, "mma"), (64, "mma"), (127, "mma"), (128, "tiled"),
                                    (256, "tiled"), (512, "tiled")])
def test_gmm_forward_route_by_capacity(C, want):
    """The product's kernel is a function of dtype, shapes and alignment:
    bf16 with 16-byte rows takes the weight-streaming kernel below
    TILED_MIN_C = 128 capacity rows (serving) and the gradients' GEMM from
    there on (granite-moe-3b-a800m trains at C = 256); anything else the
    CUDA-core kernel."""
    params = inspect.signature(gmm_ops.route).parameters
    assert list(params) == ["dtype", "C", "d", "f", "aligned"]
    assert gmm_ops.route(torch.bfloat16, C, 1536, 512, True) == want
    assert gmm_ops.route(torch.float32, C, 1536, 512, True) == "fma"
    assert gmm_ops.route(torch.bfloat16, C, 1536, 512, False) == "fma"
    assert gmm_ops.route(torch.bfloat16, C, 1536, 12, True) == "fma"


def test_gmm_only_the_needed_gradient_is_computed():
    x, w = torch.randn(2, 5, 8, requires_grad=True), torch.randn(2, 8, 4)
    (dx,) = torch.autograd.grad(gmm_ops.grouped_matmul(x, w).sum(), (x,))
    assert dx.shape == x.shape


def _cuda_route(monkeypatch, module):
    """Send CPU tensors down ``module``'s CUDA branch, as if they lay on a card."""
    monkeypatch.setattr(module, "kernel_route", lambda *tensors: "cuda")


def test_cuda_decode_attention_raises_under_grad(monkeypatch):
    q = torch.randn(2, 4, 32, requires_grad=True)
    kc, vc = torch.randn(2, 16, 2, 32), torch.randn(2, 16, 2, 32)
    lens = torch.tensor([5, 16], dtype=torch.int32)
    out = da_ops.decode_attention(q, kc, vc, lens)          # the plain version
    assert torch.autograd.grad(out.sum(), q)[0].abs().sum() > 0
    _cuda_route(monkeypatch, da_ops)
    with pytest.raises(NotImplementedError, match="backward"):
        da_ops.decode_attention(q, kc, vc, lens)


def _ssd_small(requires_grad=False):
    Bsz, S, H, P, N = 1, 8, 2, 8, 16
    x = torch.randn(Bsz, S, H, P, requires_grad=requires_grad)
    dt = torch.rand(Bsz, S, H) * 0.1
    A, D = -torch.rand(H) - 0.5, torch.randn(H)
    Bm, Cm = torch.randn(Bsz, S, N), torch.randn(Bsz, S, N)
    return x, dt, A, Bm, Cm, D


def test_cuda_ssd_scan_gradients_go_through_the_backward_kernel_entry(monkeypatch):
    """On the card, under grad, the scan runs inside _SSDScan: its forward is
    the kernel call (counted once) and its backward hands the saved inputs,
    the very tensors (x a strided view, as the model's conv-buffer slice is),
    and the cotangent to ssd_scan_bwd, whose gradients come back as they are."""
    Bsz, S, H, P, N = 1, 8, 2, 8, 16
    buf = torch.randn(Bsz, S, H * P + 2 * N)
    x = buf[..., :H * P].view(Bsz, S, H, P).requires_grad_()
    _, dt, A, Bm, Cm, D = _ssd_small()
    for t in (dt, A, Bm, Cm, D):
        t.requires_grad_()
    init = torch.randn(Bsz, H, P, N, requires_grad=True)
    y = ms_ops.ssd_scan(x, dt, A, Bm, Cm, D, init)           # the plain version
    assert torch.autograd.grad(y.sum(), x)[0].abs().sum() > 0
    calls = []

    def launch(*args):
        calls.append(("fwd", args))
        return torch.zeros(Bsz, S, H, P), torch.zeros(Bsz, H, P, N)

    def bwd(*args):
        calls.append(("bwd", args))
        return tuple(torch.full_like(t, float(i + 1)) for i, t in enumerate(args[:7]))

    _cuda_route(monkeypatch, ms_ops)
    monkeypatch.setattr(ms_ops, "_launch", launch)
    monkeypatch.setattr(ms_ops, "ssd_scan_bwd", bwd)
    inputs = (x, dt, A, Bm, Cm, D, init)
    y = ms_ops.ssd_scan(*inputs)
    dy = torch.randn(Bsz, S, H, P)
    grads = torch.autograd.grad(y, inputs, dy)
    (kind, fargs), (kind2, bargs) = calls
    assert kind == "fwd" and kind2 == "bwd"
    assert all(a is b for a, b in zip(fargs, inputs))
    assert all(a is b for a, b in zip(bargs[:7], inputs)) and torch.equal(bargs[7], dy)
    for i, g in enumerate(grads):
        assert torch.equal(g, torch.full_like(inputs[i], float(i + 1)))


def test_cuda_ssd_scan_with_state_raises_under_grad(monkeypatch):
    """Only y is differentiable, as in the JAX package (its with_state path
    takes the kernel that has no VJP): the card refuses a final state under
    grad, and still gives it without."""
    x, dt, A, Bm, Cm, D = _ssd_small(requires_grad=True)
    _, st = ms_ops.ssd_scan(x, dt, A, Bm, Cm, D, with_state=True)   # the plain version
    assert torch.autograd.grad(st.sum(), x)[0].abs().sum() > 0
    _cuda_route(monkeypatch, ms_ops)
    monkeypatch.setattr(ms_ops, "_launch", lambda *a: (torch.zeros_like(x), torch.zeros(1)))
    with pytest.raises(NotImplementedError, match="differentiable"):
        ms_ops.ssd_scan(x, dt, A, Bm, Cm, D, with_state=True)
    with torch.no_grad():
        assert ms_ops.ssd_scan(x, dt, A, Bm, Cm, D, with_state=True)[0].shape == x.shape


# (B, S, H, P, N): tests/test_kernels.py's SSD sweep, ragged S (a padded last
# chunk: 100 = 64 + 36, 200 = 3 x 64 + 8) and one token
SSD_BWD_CASES = [(1, 64, 2, 16, 16), (2, 128, 3, 16, 32), (1, 128, 1, 64, 64),
                 (2, 100, 2, 8, 16), (2, 200, 2, 8, 16), (2, 1, 2, 8, 16)]
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")


@lru_cache(None)
def _ssd_bwd_case(B, S, H, P, N, init):
    """numpy inputs (the reference's SSD sweep distributions), a cotangent,
    and jax.vjp of the token scan's y at them (dinit None without init)."""
    rng = np.random.default_rng(hash((B, S, H, P, N, init)) % 2**31)
    f = np.float32
    args = (rng.normal(size=(B, S, H, P)).astype(f), rng.uniform(0.001, 0.1, (B, S, H)).astype(f),
            -rng.uniform(0.5, 2.0, (H,)).astype(f), rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f), rng.normal(size=(H,)).astype(f),
            rng.normal(size=(B, H, P, N)).astype(f) if init else None)
    dy = rng.normal(size=(B, S, H, P)).astype(f)
    _, vjp = jax.vjp(lambda *a: jms_ref.ssd_reference(*a)[0], *args)
    want = tuple(None if g is None else np.asarray(g) for g in vjp(jnp.asarray(dy)))
    return args, dy, want


def _check_ssd_grads(got, want):
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        if w is None:
            continue
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N", SSD_BWD_CASES)
def test_ssd_backward_reference_matches_jax_vjp(B, S, H, P, N, init):
    """The plain chunked reverse pass, the algorithm the backward kernel
    runs, against the reference's custom VJP rule (jax.vjp of the scan)."""
    args, dy, want = _ssd_bwd_case(B, S, H, P, N, init)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    got = ms_ref.ssd_backward_reference(*targs, torch.from_numpy(dy))
    assert len(got) == 7 and got[6].shape == (B, H, P, N)
    _check_ssd_grads(got, want)
    # the entry point the card's Function calls takes the plain pass on the CPU
    for a, b in zip(ms_ops.ssd_scan_bwd(*targs, torch.from_numpy(dy)), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N", SSD_BWD_CASES)
def test_ssd_scan_autograd_matches_jax_vjp(B, S, H, P, N, init):
    """The port's CPU route (autograd through the plain chunked scan) against
    the same VJP: what the hybrid family trains with on the CPU."""
    args, dy, want = _ssd_bwd_case(B, S, H, P, N, init)
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_() for a in args]
    y = ms_ops.ssd_scan(*leaves)
    got = torch.autograd.grad(y, [t for t in leaves if t is not None], torch.from_numpy(dy))
    _check_ssd_grads(got, want)


@pytest.mark.parametrize("P,N,dtype", [(64, 64, torch.bfloat16), (16, 16, torch.bfloat16),
                                         (64, 128, torch.bfloat16), (128, 64, torch.bfloat16),
                                         (64, 64, torch.float32), (16, 16, torch.float32),
                                         (32, 128, torch.float32)])
def test_ssd_bwd_fits_a_block_at_the_models_shapes(P, N, dtype):
    """The chunked backward's blocks hold a slice of a head, never a whole
    state: at zamba2-1.2b's (P = N = 64) and its smoke config's heads, N =
    128 at P = 64, P = 128 at N = 64 and N = 128 at P = 32, the chunk
    kernel's block fits an SM in either dtype, its states kernel takes P in
    slices of STATE_ROWS rows, and the CUDA-core route keeps the state in
    fp64 for fp32 inputs."""
    acc = 8 if dtype == torch.float32 else 4
    assert ms_ops.state_dtype(dtype) == (torch.float64 if acc == 8 else torch.float32)
    variant = "mma" if dtype == torch.bfloat16 else "fma"
    plan = ms_ops.bwd_plan(2, 200, 3, P, N, dtype, variant, 132)
    assert ms_ops.chunk_smem_bytes(N, variant, dtype) <= 232448 and plan.blocks_per_sm >= 1
    rows = ms_ops.STATE_ROWS[variant]
    assert plan.states_grid == (2 * -(-(-(-P // 64) * 64 if variant == "mma" else P) // rows),
                                3, 2)
    assert plan.state_bytes == 2 * 2 * 3 * 4 * (-(-P // 64) * 64 if variant == "mma" else P) * \
        N * (4 if variant == "mma" else acc)


def _bwd_stub(monkeypatch):
    """Send CPU tensors down ssd_scan_bwd's CUDA branch with the C entry
    point stubbed: returns the list its calls are recorded in."""
    calls = []

    def lib(*args):
        calls.append(args)
        return 0

    _cuda_route(monkeypatch, ms_ops)
    monkeypatch.setattr(ms_ops, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(ms_ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ms_ops, "_stream", lambda dev: 0)
    return calls


@pytest.mark.parametrize("P,N,dtype,variant", [(128, 128, torch.bfloat16, "mma"),
                                               (64, 128, torch.float32, "fma"),
                                               (200, 64, torch.bfloat16, "mma"),
                                               (300, 128, torch.float32, "fma"),
                                               (12, 16, torch.bfloat16, "fma")])
def test_ssd_bwd_takes_a_head_the_first_kernel_refused(monkeypatch, P, N, dtype, variant):
    """Heads the two-sweep kernel refused before launch (P = N = 128 in bf16,
    P = 64 at N = 128 in fp32) and larger ones route to the kernel through
    the C entry point (stubbed here) with the plan's variant, group size and
    workspaces, and do not raise; bf16 with P not a multiple of 8 takes the
    CUDA cores."""
    B, S, H = 1, 70, 2
    x, dy = torch.randn(B, S, H, P).to(dtype), torch.randn(B, S, H, P).to(dtype)
    dt, A, D = torch.rand(B, S, H) * 0.1, -torch.rand(H) - 0.5, torch.randn(H)
    Bm, Cm = torch.randn(B, S, N).to(dtype), torch.randn(B, S, N).to(dtype)
    assert ms_ops.ssd_scan_bwd(x, dt, A, Bm, Cm, D, None, dy)[0].shape == x.shape
    calls = _bwd_stub(monkeypatch)
    before = ms_ops.ssd_scan_bwd.launches
    grads = ms_ops.ssd_scan_bwd(x, dt, A, Bm, Cm, D, None, dy)
    assert ms_ops.ssd_scan_bwd.launches == before + 1 and len(calls) == 1
    assert [tuple(g.shape) for g in grads] == [(B, S, H, P), (B, S, H), (H,), (B, S, N),
                                                (B, S, N), (H,), (B, H, P, N)]
    args = calls[0]
    plan = ms_ops.bwd_plan(B, S, H, P, N, dtype, variant, 132)
    assert args[18:23] == (B, S, H, P, N)
    assert args[31:34] == (plan.heads_per_group, 1 if dtype == torch.bfloat16 else 0,
                           ms_ops.BWD_VARIANTS[variant])
