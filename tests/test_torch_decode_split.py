"""The bf16 decode kernel's split-KV form on the CPU: its plain split-and-
merge version (``decode_attention_split_reference``) against the JAX
package's decode oracles, and the host-side rule that picks the number of
splits. Same numpy inputs to both sides; the repo's tolerances
(tests/test_kernels.py): fp32 2e-5, bf16 2e-2. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ref as jda_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

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


def _span(S, splits):
    return cdiv(cdiv(S, da_ops.SPAN_UNIT), splits) * da_ops.SPAN_UNIT


def _lengths(S, splits, B):
    """Lengths on and beside tile and split edges, across a split boundary
    inside a window of 64, at and past Smax; cycled to B entries."""
    span = _span(S, splits)
    edges = sorted({e for e in (1, 63, 64, 65, span - 1, span, span + 1, span + 30,
                                S, S + 37) if e >= 1})
    return [np.array((edges * B)[i:i + B], np.int32) for i in range(0, len(edges), B)]


@pytest.mark.parametrize("B,H,KH,D,S,splits", [
    (2, 4, 2, 64, 512, 3),     # 8 units in spans of 3, 3, 2
    (3, 6, 6, 32, 300, 5),     # a ragged last unit; spans of one unit
    (4, 12, 2, 64, 256, 4),    # qwen2's group of 6 at the serving cache
    (2, 8, 1, 128, 200, 2),    # G = 8, the ragged tail inside the last split
])
@pytest.mark.parametrize("window", [0, 64])
def test_split_reference_matches_the_jax_oracle(B, H, KH, D, S, splits, window):
    """Per-split (m, l, acc) merged in split order equals the JAX
    repeat-based oracle: empty splits (short lengths), a window across a
    split boundary and lengths past Smax included."""
    rng = np.random.default_rng(B * 1000 + S + splits)
    jq, q = _both(rng.normal(size=(B, H, D)), "float32")
    jk, k = _both(rng.normal(size=(B, S, KH, D)), "float32")
    jv, v = _both(rng.normal(size=(B, S, KH, D)), "float32")
    for lens in _lengths(S, splits, B):
        got = da_ref.decode_attention_split_reference(q, k, v, torch.from_numpy(lens),
                                                      splits=splits, window=window)
        want = jda_ref.decode_attention_reference(jq, jk, jv, jnp.asarray(lens),
                                                  window=window)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("float32"),
                                   err_msg=f"lengths {lens.tolist()}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_reference_matches_the_grouped_oracle(dtype):
    """Against the JAX grouped-einsum form (K/V in the cache's dtype, fp32
    sums), across several split counts."""
    rng = np.random.default_rng(11)
    B, H, KH, D, S = 4, 12, 2, 64, 640
    jq, q = _both(rng.normal(size=(B, H, D)), dtype)
    jk, k = _both(rng.normal(size=(B, S, KH, D)), dtype)
    jv, v = _both(rng.normal(size=(B, S, KH, D)), dtype)
    lens = np.array([1, 129, 640, 700], np.int32)
    for splits in (1, 2, 3, 10):
        for window in (0, 64):
            got = da_ref.decode_attention_split_reference(q, k, v, torch.from_numpy(lens),
                                                          splits=splits, window=window)
            want = jda_ref.decode_attention_grouped(jq, jk, jv, jnp.asarray(lens),
                                                    window=window)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       **_tol(dtype), err_msg=f"splits {splits} window {window}")


def test_empty_splits_weigh_zero():
    """A length of 1 over 8 splits leaves 7 splits with no key: each has
    m = NEG_INF and l = 0, and the result is exactly key 0's value."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 512, 1, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 512, 1, 32)).astype(np.float32))
    out = da_ref.decode_attention_split_reference(q, k, v, torch.tensor([1], dtype=torch.int32),
                                                  splits=8)
    np.testing.assert_allclose(out.numpy(), v[:, 0].expand(1, 2, 32).numpy(), rtol=1e-6)


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), KH=st.integers(1, 32), Smax=st.integers(1, 70000),
       sms=st.integers(1, 160))
def test_split_rule_covers_the_sms_and_never_leaves_a_split_empty(B, KH, Smax, sms):
    """Every split holds a unit of the cache; the splits cover the SMs
    unless one more split would cut the spans below the minimum; the
    combine's limit holds."""
    units = cdiv(Smax, da_ops.SPAN_UNIT)
    splits = da_ops.split_count(B, KH, Smax, sms)
    per = cdiv(units, splits)                       # the kernel's span, in units
    assert 1 <= splits <= min(units, da_ops.MAX_SPLITS)
    assert (splits - 1) * per < units               # the last split holds a unit too
    assert B * KH * splits >= sms or units // (splits + 1) < da_ops.MIN_UNITS_PER_SPLIT


def test_split_rule_takes_shapes_only():
    """The split count is a function of B, KH, Smax and the SM count (the
    caller passes the card's; 132 on an H100 SXM): the lengths, which live
    on the device, are never read on the host. The serving path's 256-key
    cache takes one split."""
    params = inspect.signature(da_ops.split_count).parameters
    assert list(params) == ["B", "KH", "Smax", "sms"]
    assert all(p.default is inspect.Parameter.empty for p in params.values())
    assert [da_ops.split_count(B, KH, S, 132) for B, KH, S in
            ((8, 2, 256), (8, 8, 256), (8, 32, 256), (1, 2, 4096), (8, 2, 4096),
             (8, 8, 4096), (1, 32, 4096))] == [1, 1, 1, 16, 10, 4, 6]


def test_split_counters_are_per_stream(monkeypatch):
    """Launches on two streams may overlap, so each (device, stream) gets
    its own zeroed arrival counters; one stream reuses its buffer, grown
    when a call needs more."""
    monkeypatch.setattr(da_ops, "_COUNTERS", {})
    dev = torch.device("cpu")
    a, b = da_ops._counters(dev, 1, 16), da_ops._counters(dev, 2, 16)
    assert a.data_ptr() != b.data_ptr()
    assert a.dtype == torch.int32 and not a.any() and not b.any()
    assert da_ops._counters(dev, 1, 16).data_ptr() == a.data_ptr()
    big = da_ops._counters(dev, 1, 10_000)
    assert big.numel() >= 10_000 and not big.any()
    assert da_ops._counters(dev, 2, 16).data_ptr() == b.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_never_calls_the_split_reference(monkeypatch, dtype):
    def boom(*a, **k):
        raise AssertionError("the split reference is a test oracle only")

    monkeypatch.setattr(da_ref, "decode_attention_split_reference", boom)
    q = torch.zeros(2, 4, 32, dtype=dtype)
    cache = torch.ones(2, 300, 2, 32, dtype=dtype)
    out = da_ops.decode_attention(q, cache, cache, torch.tensor([5, 290], dtype=torch.int32))
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
