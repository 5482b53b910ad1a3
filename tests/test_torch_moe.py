"""The port's MoE on the CPU against the JAX package: the grouped matmul's
plain version against gmm_pallas (interpret mode) and its jnp oracle, and
both dispatch paths (one-hot and sorted) against their JAX counterparts on
the granite and dbrx smoke configs, with and without capacity drops. Same
numpy inputs and the same params on both sides. Tolerances: gmm fp32 1e-4,
bf16 atol 1e-1 / rtol 5e-2 (tests/test_kernels.py); MoE layers fp32 1e-5
(tests/test_moe_dispatch.py). The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels.moe_gmm import ops as jgmm_ops
from repro.models import mlp as jmlp
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.models import mlp

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_TOL = dict(atol=1e-5, rtol=1e-5)


def _both(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor holding the same
    values (bf16 rounded once, by JAX)."""
    ja = jnp.asarray(a, _DT[dtype][0])
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(_DT[dtype][1])


# -------------------------------------------------------------------- gmm
@pytest.mark.parametrize("E,C,d,f", [(2, 32, 16, 16), (4, 64, 96, 160),
                                     (8, 128, 128, 128), (3, 5, 96, 160),
                                     (2, 37, 64, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_matches_pallas_interpret_and_ref(E, C, d, f, dtype):
    rng = np.random.default_rng(hash((E, C, d, f)) % 2**31)
    jx, x = _both(rng.normal(size=(E, C, d)), dtype)
    jw, w = _both(rng.normal(size=(E, d, f)), dtype)
    out = gmm_ops.grouped_matmul(x, w)
    assert out.shape == (E, C, f) and out.dtype == x.dtype
    tol = dict(atol=1e-1, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    for impl in ("pallas_interpret", "ref"):
        want = jgmm_ops.grouped_matmul(jx, jw, impl=impl)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   err_msg=impl, **tol)


def test_gmm_cpu_path_does_not_count_launches():
    x, w = torch.ones(2, 4, 8), torch.ones(2, 8, 16)
    before = gmm_ops.grouped_matmul.launches
    torch.testing.assert_close(gmm_ops.grouped_matmul(x, w), gmm_ref.gmm_reference(x, w))
    assert gmm_ops.grouped_matmul.launches == before


@pytest.mark.parametrize("bad", ["rank", "experts", "depth", "mixed_dtype", "float16",
                                 "noncontiguous", "empty"])
def test_gmm_rejects_what_the_kernel_does_not_take(bad):
    x, w = torch.zeros(2, 4, 8), torch.zeros(2, 8, 16)
    args = {"rank": (x[0], w), "experts": (x, w[:1]), "depth": (x, w[:, :4]),
            "mixed_dtype": (x, w.bfloat16()), "float16": (x.half(), w.half()),
            "noncontiguous": (x, w.transpose(1, 2).contiguous().transpose(1, 2)),
            "empty": (x[:, :0], w)}[bad]
    with pytest.raises((ValueError, TypeError)):
        gmm_ops.grouped_matmul(*args)


# ------------------------------------------------------------ MoE layers
def _moe_setup(arch, factor=None, B=2, S=24, skew=0.0, seed=0):
    """JAX moe_init params (and their port copy), tokens (B, S, d) from
    numpy. ``skew`` pulls every token towards expert 0's router column, so
    that its queue overflows at the default capacity."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    if factor is not None:
        jcfg, cfg = (c.with_(moe_capacity_factor=factor) for c in (jcfg, cfg))
    jp, _ = jmlp.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    router = np.array(jp["router"])
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(B, S, cfg.d_model)) \
        + skew * router[:, 0] / np.linalg.norm(router[:, 0])
    jx, tx = _both(x)
    return jcfg, cfg, jp, p, jx, tx


def _assert_same_experts(jp, p, cfg, jx, tx):
    """torch.topk and lax.top_k need not order tied values alike: the chosen
    expert sets must agree before outputs are compared."""
    jprobs = jax.nn.softmax(jx.reshape(-1, cfg.d_model) @ jp["router"], -1)
    _, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    probs = torch.softmax(tx.reshape(-1, cfg.d_model) @ p["router"], -1)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices
    assert [sorted(r) for r in np.asarray(jidx).tolist()] == \
        [sorted(r) for r in idx.tolist()]


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "dbrx-132b"])
def test_moe_matches_jax_with_and_without_drops(arch, impl):
    jfn = {"onehot": jmlp.moe_forward_onehot, "sorted": jmlp.moe_forward_sorted}[impl]
    fn = {"onehot": mlp.moe_forward_onehot, "sorted": mlp.moe_forward_sorted}[impl]
    ys = {}
    for factor in (None, 100.0):               # default capacity (drops), none
        jcfg, cfg, jp, p, jx, tx = _moe_setup(arch, factor, skew=3.0)
        _assert_same_experts(jp, p, cfg, jx, tx)
        jy, jaux = jfn(jp, jcfg, jx)
        y, aux = fn(p, cfg, tx)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
        ys[factor] = y
    assert not torch.allclose(ys[None], ys[100.0]), "no assignment was dropped"


def test_onehot_queue_order_drops_the_later_tokens():
    """Queue slots go in token-major order: under a tight capacity the
    first tokens keep their experts and the last ones are dropped, as in
    JAX (in decode, the idle slots with token 0 come before the live ones
    of higher slot index)."""
    jcfg, cfg, jp, p, jx, tx = _moe_setup("granite-moe-3b-a800m", 0.05, B=1,
                                          S=64, skew=3.0)
    y, _ = mlp.moe_forward_onehot(p, cfg, tx)
    jy, _ = jmlp.moe_forward_onehot(jp, jcfg, jx)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
    served = y[0].abs().sum(-1) > 0
    assert bool(served[:4].all()) and not bool(served[-8:].any())


# ------------------------------------- dispatch checks, on the port alone
def _naive(p, cfg, x):
    """Per-token oracle: every token through its top-k experts, no capacity."""
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], -1)
    gv, gi = torch.topk(probs, cfg.top_k, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for k in range(cfg.top_k):
            e = int(gi[t, k])
            h = torch.nn.functional.silu(xt[t] @ p["wg"][e]) * (xt[t] @ p["wu"][e])
            y[t] += gv[t, k] * (h @ p["wd"][e])
    return y.reshape(x.shape)


@pytest.fixture(scope="module")
def no_drops():
    _, cfg, _, p, _, tx = _moe_setup("granite-moe-3b-a800m", 100.0, B=2, S=8)
    return cfg, p, tx


def test_sorted_equals_onehot_no_drops(no_drops):
    """Outputs agree. The aux losses differ by a factor top_k, as in the JAX
    package: the one-hot path's f_e is the share of tokens sent to expert e
    (summing to K over experts), the sorted path's the share of assignments
    (summing to 1). Each path matches its JAX counterpart above."""
    cfg, p, x = no_drops
    y1, aux1 = mlp.moe_forward_onehot(p, cfg, x)
    y2, aux2 = mlp.moe_forward_sorted(p, cfg, x)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), **MOE_TOL)
    np.testing.assert_allclose(float(aux2) * cfg.top_k, float(aux1), **MOE_TOL)


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
def test_both_match_naive_oracle(no_drops, impl):
    cfg, p, x = no_drops
    y, _ = mlp.moe_forward(p, cfg.with_(moe_impl=impl), x)
    np.testing.assert_allclose(y.numpy(), _naive(p, cfg, x).numpy(), **MOE_TOL)


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
def test_tight_capacity_stays_finite(impl):
    """With a tight capacity, outputs stay finite and dropped tokens get
    partial (or zero) expert contributions -- never NaN."""
    _, cfg, _, p, _, x = _moe_setup("granite-moe-3b-a800m", 0.25, B=2, S=16, seed=2)
    y, aux = mlp.moe_forward(p, cfg.with_(moe_impl=impl), x)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))
    y2, _ = mlp.moe_forward(p, cfg.with_(moe_impl=impl, moe_capacity_factor=100.0), x)
    assert float(torch.linalg.norm(y2)) >= float(torch.linalg.norm(y)) - 1e-6


@pytest.mark.parametrize("T,want", [(8, 4), (16, 4), (32, 8), (64, 16)])
def test_onehot_capacity_at_the_serving_shapes(T, want, monkeypatch):
    """granite at full width: decode (T = max_batch = 8) and the prefill
    buckets 16 / 32 / 64 give the capacities 4 / 4 / 8 / 16."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("granite-moe-3b-a800m").with_(d_model=8, d_ff=4)
    seen = []
    monkeypatch.setattr(mlp, "_experts", lambda p, xe: seen.append(xe.shape) or xe)
    g = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(8, cfg.n_experts, generator=g)}
    mlp.moe_forward_onehot(p, cfg, torch.randn(1, T, 8, generator=g))
    assert seen == [(cfg.n_experts, want, 8)]


# ------------------------------------------------------- gmm kernel choice
_SERVED_GMM = [(40, C, d, f) for C in (1, 4, 16, 17, 64) for d, f in ((1536, 512), (512, 1536))]
_RAGGED_GMM = [(2, 32, 16, 16), (4, 64, 96, 160), (8, 128, 128, 128), (3, 5, 96, 160),
               (2, 37, 64, 12), (2, 16, 8, 12), (3, 17, 104, 136), (2, 8, 100, 64)]


@pytest.mark.parametrize("E,C,d,f", _SERVED_GMM + _RAGGED_GMM)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_gmm_plan_variant(E, C, d, f, dtype, aligned):
    """bf16 with d and f multiples of 8 and aligned operands takes the
    tensor-core kernel (one block per (expert, 64-column f tile), any C);
    fp32, ragged rows or a misaligned w the CUDA-core kernel."""
    want = dtype == "bfloat16" and d % 8 == 0 and f % 8 == 0 and aligned
    assert gmm_ops.takes_mma(_DT[dtype][1], d, f, aligned) == want
