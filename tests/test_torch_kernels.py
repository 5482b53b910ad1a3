"""The port's attention entry points on the CPU (their plain versions)
against the JAX package's kernels: Pallas in interpret mode where the
shapes fit its blocks, the jnp oracle for ragged shapes. Same numpy
inputs to both; the repo's tolerances (tests/test_kernels.py): fp32 2e-5,
bf16 2e-2. The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jda_ops
from repro.kernels.decode_attention import ref as jda_ref
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of the same dtype
    (bf16 rounded once, by JAX, so both sides see identical values)."""
    ja = jnp.asarray(a, _DT[dtype][0])
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(_DT[dtype][1])


def _close(out, want, dtype, what="", exact=None):
    """Port output against the JAX output. Given ``exact`` (a float64
    computation on the same inputs), each side is also held against it,
    and a failure says which side moved."""
    got, ref = out.float().numpy(), np.asarray(want, np.float32)
    note = what
    if exact is not None:
        e_port, e_jax = (float(np.abs(a - exact).max()) for a in (got, ref))
        note = f"{what}: port vs float64 {e_port:.2e}, jax vs float64 {e_jax:.2e}"
        np.testing.assert_allclose(got, exact, **_tol(dtype), err_msg=f"port moved; {note}")
        np.testing.assert_allclose(ref, exact, **_tol(dtype), err_msg=f"jax moved; {note}")
    np.testing.assert_allclose(got, ref, **_tol(dtype), err_msg=note)


def _attention_f64(q, k, v, causal, window):
    """Float64 numpy attention (suffix-aligned causal mask, optional window)
    on the exact values both sides were given."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    Sq, H, D = q.shape[1:]
    Sk, KH = k.shape[1:3]
    k, v = (np.repeat(t, H // KH, axis=2) for t in (k, v))
    logits = np.einsum("bqhd,bkhd->bhqk", q * D ** -0.5, k)
    qp, kp = np.arange(Sq)[:, None] + (Sk - Sq), np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    logits = np.where(mask, logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("B,S,H,KH,D,causal,window,dtype", [
    (1, 128, 1, 1, 64, True, 0, "float32"),
    (2, 256, 4, 2, 64, True, 64, "float32"),
    (1, 256, 8, 8, 128, False, 0, "bfloat16"),
    (2, 128, 6, 2, 32, True, 64, "bfloat16"),
])
def test_flash_matches_pallas_interpret(B, S, H, KH, D, causal, window, dtype):
    rng = np.random.default_rng(hash((B, S, H, KH, D, causal, window)) % 2**31)
    jq, q = _both(rng.normal(size=(B, S, H, D)), dtype)
    jk, k = _both(rng.normal(size=(B, S, KH, D)), dtype)
    jv, v = _both(rng.normal(size=(B, S, KH, D)), dtype)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    exact = _attention_f64(q, k, v, causal, window) if dtype == "float32" else None
    for impl in ("pallas_interpret", "ref"):
        want = jfa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                       impl=impl)
        _close(out, want, dtype, impl, exact)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (100, 100, True, 0), (100, 100, True, 64), (64, 100, False, 0),
    (37, 90, True, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ragged_matches_reference(Sq, Sk, causal, window, dtype):
    """Shapes the Pallas kernel's divisibility assert refuses."""
    rng = np.random.default_rng(Sq * 1000 + Sk)
    jq, q = _both(rng.normal(size=(2, Sq, 12, 32)), dtype)
    jk, k = _both(rng.normal(size=(2, Sk, 2, 32)), dtype)
    jv, v = _both(rng.normal(size=(2, Sk, 2, 32)), dtype)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(out, jfa_ref.mha_reference(jq, jk, jv, causal=causal, window=window),
           dtype)


# ----------------------------------------------------------------- decode
@pytest.mark.parametrize("B,H,KH,D,S,dtype", [
    (2, 4, 2, 64, 512, "float32"), (1, 8, 1, 128, 256, "bfloat16"),
    (3, 6, 6, 32, 512, "float32"),
])
def test_decode_matches_pallas_interpret(B, H, KH, D, S, dtype):
    rng = np.random.default_rng(hash((B, H, KH, D, S)) % 2**31)
    jq, q = _both(rng.normal(size=(B, H, D)), dtype)
    jk, k = _both(rng.normal(size=(B, S, KH, D)), dtype)
    jv, v = _both(rng.normal(size=(B, S, KH, D)), dtype)
    lens = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    for window in (0, 64):
        out = da_ops.decode_attention(q, k, v, torch.from_numpy(lens),
                                      window=window)
        want = jda_ops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                        window=window, impl="pallas_interpret")
        _close(out, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ragged_and_overlong_lengths(dtype):
    """Smax that no Pallas block divides, and a length past Smax (an idle
    serving slot): the whole cache attends, as in the JAX oracle."""
    rng = np.random.default_rng(7)
    B, H, KH, D, S = 4, 12, 2, 64, 300
    jq, q = _both(rng.normal(size=(B, H, D)), dtype)
    jk, k = _both(rng.normal(size=(B, S, KH, D)), dtype)
    jv, v = _both(rng.normal(size=(B, S, KH, D)), dtype)
    lens = np.array([1, 150, S, S + 37], np.int32)
    for window in (0, 64):
        out = da_ops.decode_attention(q, k, v, torch.from_numpy(lens),
                                      window=window)
        want = jda_ref.decode_attention_reference(jq, jk, jv, jnp.asarray(lens),
                                                  window=window)
        _close(out, want, dtype)


# --------------------------------------------------------------- wrappers
def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 16, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 16, 2, 32)).astype(np.float32))
    cache = torch.zeros(1, 32, 2, 32)
    before = (fa_ops.flash_attention.launches, da_ops.decode_attention.launches)
    fa_ops.flash_attention(q, k, k)
    da_ops.decode_attention(q[:, 0], cache, cache,
                            torch.tensor([5], dtype=torch.int32))
    assert (fa_ops.flash_attention.launches,
            da_ops.decode_attention.launches) == before


@pytest.mark.parametrize("bad", ["noncontiguous", "mixed_dtype", "float16",
                                 "gqa_mismatch", "lengths_int64"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 16, 4, 32)
    k = torch.zeros(1, 16, 2, 32)
    lens = torch.tensor([3], dtype=torch.int32)
    if bad == "noncontiguous":
        call = lambda: fa_ops.flash_attention(q.transpose(1, 2), k, k)  # noqa: E731
    elif bad == "mixed_dtype":
        call = lambda: fa_ops.flash_attention(q, k.bfloat16(), k)  # noqa: E731
    elif bad == "float16":
        call = lambda: fa_ops.flash_attention(q.half(), k.half(), k.half())  # noqa: E731
    elif bad == "gqa_mismatch":
        call = lambda: fa_ops.flash_attention(torch.zeros(1, 16, 3, 32), k, k)  # noqa: E731
    else:
        call = lambda: da_ops.decode_attention(q[:, 0], k, k, lens.long())  # noqa: E731
    with pytest.raises((ValueError, TypeError)):
        call()


def test_build_command_targets_sm90a(monkeypatch):
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    cmd = build.nvcc_command("flash_attention", build.library_path("flash_attention"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/flash_attention.cu")
    assert set(build.sources()) == {"flash_attention", "flash_attention_bwd",
                                    "decode_attention", "moe_gmm", "mamba_scan",
                                    "mamba_scan_bwd"}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build, "TOOLKIT_NVCC", "/nonexistent/bin/nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["flash_attention"])
    assert not build.BUILD_DIR.exists()
