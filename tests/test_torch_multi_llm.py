"""The port's multi-LLM example (repro_torch.examples.serve_multi_llm) on the
CPU at smoke size: the JAX example's seed and trace, cut to a few requests
per model. On the same params (JAX init with key 0, as the JAX example
makes them, carried over through the checkpoint key layout), every
request's greedy tokens equal JaxEngine's."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.serving.engine import JaxEngine
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.examples import serve_multi_llm as multi

N_REQ = 3


@pytest.fixture(scope="module")
def served():
    jax_side, params = {}, {}
    for arch in multi.ARCHS:
        jcfg = jax_smoke_config(arch)
        jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
        jax_side[arch] = (jcfg, jparams)
        params[arch] = params_from_numpy(_flatten(jparams), get_smoke_config(arch), "cpu")
    finished, summary = multi.serve_multi_llm(n_req=N_REQ, params=params, device="cpu")
    return jax_side, finished, summary


def test_trace_is_the_jax_examples(served):
    """Arrivals alternate between the models; each request's prompt length
    (8-47), prompt and output length (8-23) are drawn as the JAX example
    draws them, after all the arrival times, from one generator seeded 0."""
    _, finished, _ = served
    n = N_REQ * len(multi.ARCHS)
    assert sorted(finished) == list(range(n))
    rng = np.random.default_rng(0)
    rng.exponential(1.0 / (multi.RATE * len(multi.ARCHS)), size=n)
    for rid in range(n):
        cfg = get_smoke_config(multi.ARCHS[rid % len(multi.ARCHS)])
        length = int(rng.integers(8, 48))
        np.testing.assert_array_equal(finished[rid].prompt,
                                      rng.integers(0, cfg.vocab_size, size=(length,)))
        assert finished[rid].max_new == int(rng.integers(8, 24))


def test_every_request_finishes_with_its_tokens(served):
    _, finished, summary = served
    assert set(summary) == set(multi.ARCHS)
    for i, arch in enumerate(multi.ARCHS):
        rids = range(i, N_REQ * len(multi.ARCHS), len(multi.ARCHS))
        s = summary[arch]
        assert s["requests"] == N_REQ
        assert s["tokens"] == sum(finished[r].max_new + 1 for r in rids)
        assert 0 < s["ttft_p50_s"] <= s["ttft_p95_s"]
        assert s["tok_per_s"] > 0


@pytest.mark.parametrize("arch", multi.ARCHS)
def test_greedy_tokens_equal_jax_engine(served, arch):
    jax_side, finished, _ = served
    jcfg, jparams = jax_side[arch]
    eng = JaxEngine(jcfg, jparams, max_batch=multi.MAX_BATCH, max_len=multi.MAX_LEN)
    rids = [r for r in sorted(finished) if multi.ARCHS[r % len(multi.ARCHS)] == arch]
    for rid in rids:
        eng.submit(rid, finished[rid].prompt, finished[rid].max_new)
    want = {rid: r.out_tokens for rid, r in eng.drain().items()}
    assert {rid: finished[rid].out_tokens for rid in rids} == want


def test_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve_multi_llm", "--device", "cpu", "--requests", "1",
                                     "--rate", "1000"])
    multi.main()
    out = capsys.readouterr().out
    for arch in multi.ARCHS:
        assert f"[serve]   {arch}" in out


def test_without_cuda_serving_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multi.serve_multi_llm(n_req=1)
