"""The port's SSD scan on the CPU (its plain chunked version) against the
JAX package: the token scan, the chunked form and the Pallas kernel in
interpret mode at the repo's sweep shapes (S a multiple of 64, where the
Pallas kernel runs), and the token scan at ragged S (where the Pallas
kernel asserts S % 64 == 0). Same numpy inputs to both; the repo's SSD
tolerance (tests/test_kernels.py): fp32 1e-4; bf16 x/B/C 2e-2, the repo's
bf16 kernel tolerance. The CUDA kernel itself is held against the same
plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ops as jms_ops
from repro.kernels.mamba_scan import ref as jms_ref
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, S, H, P, N, seed, dtype="float32", init=False):
    """Seeded numpy inputs, as (JAX arrays, torch tensors). x, B and C take
    ``dtype`` (bf16 rounded once, by JAX, so both sides see the same
    values); dt, A, D and the initial state stay fp32."""
    rng = np.random.default_rng(seed)
    arrs = dict(x=rng.normal(size=(B, S, H, P)),
                dt=rng.uniform(0.001, 0.1, size=(B, S, H)),
                A=-rng.uniform(0.5, 2.0, size=(H,)),
                Bm=rng.normal(size=(B, S, N)), Cm=rng.normal(size=(B, S, N)),
                D=rng.normal(size=(H,)),
                s0=rng.normal(size=(B, H, P, N)) if init else None)
    jx, tx = {}, {}
    for k, a in arrs.items():
        if a is None:
            jx[k] = tx[k] = None
            continue
        jdt, tdt = _DT[dtype] if k in ("x", "Bm", "Cm") else _DT["float32"]
        jx[k] = jnp.asarray(a, jdt)
        tx[k] = torch.from_numpy(np.array(jx[k], np.float32)).to(tdt)
    return jx, tx


def _args(d):
    return d["x"], d["dt"], d["A"], d["Bm"], d["Cm"], d["D"], d["s0"]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 64, 2, 16, 16), (2, 128, 3, 16, 32), (1, 128, 1, 64, 64),
])
def test_ssd_matches_jax_at_the_sweep_shapes(B, S, H, P, N):
    """y and the final state against the JAX token scan, chunked form and
    Pallas kernel (interpret mode)."""
    jx, tx = _inputs(B, S, H, P, N, seed=hash((B, S, H, P, N)) % 2**31)
    y, st = ms_ops.ssd_scan(*_args(tx), with_state=True)
    wants = [jms_ref.ssd_reference(*_args(jx)),
             jms_ref.ssd_chunked_reference(*_args(jx), chunk=64),
             jms_ops.ssd_scan(*_args(jx), impl="pallas_interpret", with_state=True)]
    for y_want, s_want in wants:
        _close(y, y_want, "float32")
        _close(st, s_want, "float32")


@pytest.mark.parametrize("S", [1, 33, 100, 130])
@pytest.mark.parametrize("dtype,init", [("float32", False), ("float32", True),
                                        ("bfloat16", True)])
def test_ssd_ragged_lengths_match_the_jax_token_scan(S, dtype, init):
    """Any S (the tail chunk padded with dt = 0), a nonzero initial state,
    and bf16 x/B/C with fp32 dt."""
    jx, tx = _inputs(2, S, 3, 16, 32, seed=S, dtype=dtype, init=init)
    y, st = ms_ops.ssd_scan(*_args(tx), with_state=True)
    assert y.dtype == tx["x"].dtype and st.dtype == torch.float32
    y_want, s_want = jms_ref.ssd_reference(*_args(jx))
    _close(y, y_want, dtype)
    _close(st, s_want, "float32" if dtype == "float32" else dtype)


def test_pallas_kernel_rejects_a_ragged_length_the_port_takes():
    """The reference's trap: ssd_pallas asserts S % 64 == 0, which a
    100-token exact-length hybrid prefill trips; the port takes any S."""
    jx, tx = _inputs(1, 100, 2, 16, 16, seed=4)
    with pytest.raises(AssertionError):
        jms_ops.ssd_scan(*_args(jx), impl="pallas_interpret", with_state=True)
    y, _ = ms_ops.ssd_scan(*_args(tx), with_state=True)
    _close(y, jms_ref.ssd_reference(*_args(jx))[0], "float32")


def test_plain_versions_agree():
    """The port's token scan and chunked form on the same inputs, a chunk
    smaller than S with a ragged tail included."""
    _, tx = _inputs(2, 77, 2, 8, 16, seed=6, init=True)
    y0, s0 = ms_ref.ssd_reference(*_args(tx))
    for chunk in (16, 64):
        y1, s1 = ms_ref.ssd_chunked_reference(*_args(tx), chunk=chunk)
        np.testing.assert_allclose(y1.numpy(), y0.numpy(), **TOL["float32"])
        np.testing.assert_allclose(s1.numpy(), s0.numpy(), **TOL["float32"])


def test_decode_continuation():
    """Prefill final state + one decode step == the full-sequence scan, on
    the port; and the port's decode step equals the JAX one."""
    jx, tx = _inputs(1, 33, 2, 8, 8, seed=5)
    y_all = ms_ops.ssd_scan(*_args(tx))
    pre = {k: (v[:, :-1] if k in ("x", "dt", "Bm", "Cm") else v) for k, v in tx.items()}
    _, s_pre = ms_ops.ssd_scan(*_args(pre), with_state=True)
    last = [tx[k][:, -1] for k in ("x", "dt")]
    y_step, s_step = ms_ops.decode_step(s_pre, *last, tx["A"], tx["Bm"][:, -1],
                                        tx["Cm"][:, -1], tx["D"])
    np.testing.assert_allclose(y_step.numpy(), y_all[:, -1].numpy(), atol=1e-5, rtol=1e-5)
    jy, js = jms_ref.ssd_decode_step(jnp.asarray(s_pre.numpy()), jx["x"][:, -1],
                                     jx["dt"][:, -1], jx["A"], jx["Bm"][:, -1],
                                     jx["Cm"][:, -1], jx["D"])
    _close(y_step, jy, "float32")
    _close(s_step, js, "float32")


def test_strided_slices_match_contiguous_inputs():
    """x, B and C as column slices of one buffer, as the model passes them."""
    rng = np.random.default_rng(8)
    Bsz, S, H, P, N = 2, 70, 2, 16, 16
    buf = torch.from_numpy(rng.normal(size=(Bsz, S, H * P + 2 * N)).astype(np.float32))
    x = buf[..., :H * P].reshape(Bsz, S, H, P)
    Bm, Cm = buf[..., H * P:H * P + N], buf[..., H * P + N:]
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, size=(Bsz, S, H)).astype(np.float32))
    A, D = -torch.linspace(0.5, 2.0, H), torch.ones(H)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    got = ms_ops.ssd_scan(x, dt, A, Bm, Cm, D, with_state=True)
    want = ms_ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), D,
                           with_state=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_cpu_path_takes_the_plain_version_and_counts_no_launch(monkeypatch):
    _, tx = _inputs(1, 20, 2, 16, 16, seed=9, init=True)
    called = []
    real = ms_ref.ssd_chunked_reference
    monkeypatch.setattr(ms_ref, "ssd_chunked_reference",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    before = ms_ops.ssd_scan.launches
    y = ms_ops.ssd_scan(*_args(tx))
    assert called and ms_ops.ssd_scan.launches == before
    assert y.shape == tx["x"].shape


@pytest.mark.parametrize("bad", ["mixed_compute_dtype", "bf16_dt", "float16",
                                 "x_last_axis_strided", "shape", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, tx = _inputs(1, 8, 2, 16, 16, seed=10)
    a = dict(tx)
    if bad == "mixed_compute_dtype":
        a["Bm"] = a["Bm"].bfloat16()
    elif bad == "bf16_dt":
        a["dt"] = a["dt"].bfloat16()
    elif bad == "float16":
        a.update(x=a["x"].half(), Bm=a["Bm"].half(), Cm=a["Cm"].half())
    elif bad == "x_last_axis_strided":
        a["x"] = a["x"].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "shape":
        a["D"] = a["D"][:1]
    else:
        a["A"] = a["A"].to("meta")
    with pytest.raises((ValueError, TypeError)):
        ms_ops.ssd_scan(*_args(a))
