"""The port's cost analysis and dry-run, counterparts of
tests/test_hlo_analysis.py by meaning: exact matmul FLOPs, operand and
result traffic, collective bytes of a sharded product, the small-depth
traces against a full trace, a forward against 2*N*D and against the
reference's own HLO count, and the dry-run's cells on a small fake mesh."""
import json

import pytest
import torch

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api as mapi
from repro_torch.models import common as cm

SMALL = ((2, 2), ("data", "model"))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_exact():
    a, b = _meta(64, 128), _meta(128, 32)
    _, cost = hlo_analysis.analyse(lambda: a @ b)
    assert cost.flops == 2 * 64 * 128 * 32


def test_traffic_counts_operands_and_results():
    x = _meta(256, 256)
    _, cost = hlo_analysis.analyse(lambda: x + 1.0)
    assert cost.traffic >= 2 * 256 * 256 * 4          # read and write of the 256 KB tensor
    assert cost.peak_bytes == 256 * 256 * 4           # its one new output
    _, view = hlo_analysis.analyse(lambda: x.view(-1))
    assert view.traffic == 0 and view.peak_bytes == 0


def test_sharded_matmul_counts_its_collectives():
    """A column-parallel product gathered to every rank, and a row-parallel
    one summed: the all-gather and all-reduce bytes per rank, as
    CommDebugMode counts the ops."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    with mesh_mod.process_group(4):
        mesh = mesh_mod.make_mesh((1, 4), ("data", "model"), "cpu")
        x = distribute_tensor(_meta(8, 64), mesh, [Replicate(), Replicate()])
        w = distribute_tensor(_meta(64, 128), mesh, [Replicate(), Shard(1)])
        w2 = distribute_tensor(_meta(128, 64), mesh, [Replicate(), Shard(0)])
        full = [Replicate(), Replicate()]
        col = lambda: (x @ w).redistribute(mesh, full)            # noqa: E731
        row = lambda: ((x @ w) @ w2).redistribute(mesh, full)     # noqa: E731
        _, c = hlo_analysis.analyse(col)
        assert c.collectives == {"all-gather": 8 * 128 * 4}
        assert c.flops == 2 * 8 * 64 * 32                         # the local shard's product
        _, r = hlo_analysis.analyse(row)
        assert r.collectives == {"all-reduce": 8 * 64 * 4}
        assert r.flops == 2 * (2 * 8 * 64 * 32)
        for fn in (col, row):
            with CommDebugMode() as comm:
                fn()
            assert comm.get_total_counts() == 1


def test_qwen2_forward_matches_2nd_and_the_reference_hlo():
    """A 4-layer qwen2 forward over 2 x 64 tokens: within 30% of 2*N*D, and
    within 10% of the reference's loop-aware HLO count on the same config."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as jax_smoke_config
    from repro.launch.hlo_analysis import analyse_hlo
    from repro.models import api as jax_api

    jcfg = jax_smoke_config("qwen2-1.5b").with_(n_layers=4, remat=False)
    jmodel = jax_api.get_model(jcfg)
    jshapes = jax.eval_shape(lambda k: jmodel.init(k, jcfg)[0],
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    jbatch = {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)}
    ref = analyse_hlo(jax.jit(lambda p, b: jmodel.forward(p, jcfg, b)[0])
                      .lower(jshapes, jbatch).compile().as_text())

    cfg = get_smoke_config("qwen2-1.5b").with_(n_layers=4, remat=False)
    params = cm.nest({k: _meta(*r.shape, dtype=r.dtype)
                      for k, r in mapi.param_records(cfg).items()})
    tokens = _meta(2, 64, dtype=torch.int32)
    with torch.no_grad():
        _, cost = hlo_analysis.analyse(
            lambda: mapi.get_model(cfg).forward(params, cfg, {"tokens": tokens}))
    assert cost.flops == pytest.approx(2 * cfg.param_count() * 2 * 64, rel=0.3)
    assert cost.flops == pytest.approx(ref.flops, rel=0.1)
    assert cost.traffic > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m", "qwen2-vl-2b",
                                  "whisper-base", "zamba2-1.2b", "xlstm-350m"])
def test_run_cell_at_smoke_size(tmp_path, arch, kind):
    shape = InputShape(f"smoke_{kind}", 16, 4, kind)
    rec = dryrun.run_cell(arch, shape.name, out_dir=str(tmp_path), verbose=False,
                          shape=shape, mesh_shape=SMALL, smoke=True)
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    assert rec["flops_per_device"] > 0 and rec["traffic_bytes_per_device"] > 0
    mem = rec["memory"]
    assert mem["total"] >= mem["persistent"] > 0 and mem["fits"]
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert json.loads((tmp_path / f"{rec['cell']}.json").read_text()) == rec


def test_long_context_on_a_dense_arch_is_skipped(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
    assert (tmp_path / "qwen2-1.5b__long_500k__16x16.json").exists()
