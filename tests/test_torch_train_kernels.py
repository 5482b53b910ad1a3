"""The gradients of the port's kernel entry points on the CPU (their plain
versions, through the same ``torch.autograd.Function``s the card runs)
against the JAX package: flash attention against ``jax.grad`` of
``flash_attention(impl="pallas_interpret")`` (whose custom VJP recomputes
through the oracle), atol / rtol 1e-4 as the reference's own flash gradient
check (tests/test_kernels.py); the grouped matmul against ``jax.grad`` of
``grouped_matmul(impl="pallas_interpret")``, atol 1e-5 as its gradient
check, with rtol 1e-5 for the larger sums (f up to 160 terms of randn
products: gradients near 20, whose fp32 ulp is 2e-6). The plain LSE against a float64 logsumexp, 1e-5. The CUDA kernels
are held against the same plain versions on the card by chip_smoke.py.
Also: a CUDA-routed decode attention or SSD scan raises under grad, since
neither kernel has a backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.moe_gmm import ops as jgmm_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops


GMM_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


# (B, Sq, Sk, H, KH, D, causal, window): causal, window, GQA, Sq < Sk, no
# mask, D 32 and 64 (shapes the interpret-mode kernel's blocks divide)
FLASH_CASES = [(1, 128, 128, 2, 2, 32, True, 0), (2, 128, 128, 4, 2, 64, True, 48),
               (1, 64, 128, 6, 2, 32, True, 0), (1, 64, 128, 4, 1, 64, True, 32),
               (2, 128, 128, 4, 4, 64, False, 0), (1, 64, 128, 2, 1, 32, False, 0)]


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


@pytest.mark.parametrize("E,C,d,f", [(2, 16, 8, 12), (3, 17, 24, 40), (4, 64, 96, 160)])
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


def test_cuda_ssd_scan_raises_under_grad(monkeypatch):
    Bsz, S, H, P, N = 1, 8, 2, 8, 16
    x = torch.randn(Bsz, S, H, P, requires_grad=True)
    dt = torch.rand(Bsz, S, H) * 0.1
    A, D = -torch.rand(H) - 0.5, torch.randn(H)
    Bm, Cm = torch.randn(Bsz, S, N), torch.randn(Bsz, S, N)
    y = ms_ops.ssd_scan(x, dt, A, Bm, Cm, D)                 # the plain version
    assert torch.autograd.grad(y.sum(), x)[0].abs().sum() > 0
    _cuda_route(monkeypatch, ms_ops)
    with pytest.raises(NotImplementedError, match="backward"):
        ms_ops.ssd_scan(x, dt, A, Bm, Cm, D)
