"""The dry-run's small-depth traces (``dryrun.trace_plan``) against one
trace of the whole step: the port's counterpart of the reference's scan
trip-count test (tests/test_hlo_analysis.py), since the port's models run
Python loops over layers and the sLSTM's tokens."""
import pytest

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as mesh_mod


@pytest.fixture
def small_mesh():
    """A fake group of 4 ranks and its 2x2 mesh, installed; destroyed after
    the test (a group is global to the process)."""
    with mesh_mod.process_group(4):
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with sh.use_mesh(mesh):
            yield mesh


def _depth(cfg, L):
    if cfg.family == "hybrid":
        return cfg.with_(n_layers=L, attn_every=2)
    if cfg.family == "ssm":
        return cfg.with_(n_layers=L, slstm_every=2)
    return cfg.with_(n_layers=L)


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("arch,seq", [("qwen2-1.5b", 32), ("granite-moe-3b-a800m", 32),
                                      ("qwen2-vl-2b", 32), ("zamba2-1.2b", 32),
                                      ("xlstm-350m", 16)])
def test_small_depth_traces_match_a_full_trace(small_mesh, arch, seq, depth):
    """The trace plan's linear combination against one trace of the whole
    step, at depths 2 and 8 (the xLSTM at S=16 also extrapolates its sLSTM
    layer from S=4 and 8): FLOPs, traffic and collective bytes within
    1%."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _depth(get_smoke_config(arch), depth)
    shape = InputShape("t", seq, 4, "train")
    est, _ = dryrun.estimate(cfg, shape)
    step = dryrun.build_step(cfg, shape)
    with implicit_replication():
        step.fn()                  # DTensor's first-call planning, uncounted (as in estimate)
        _, full = hlo_analysis.analyse(step.fn, base_bytes=step.persistent)
    assert est.flops == pytest.approx(full.flops, rel=0.01)
    assert est.traffic == pytest.approx(full.traffic, rel=0.01)
    assert est.collective_total == pytest.approx(full.collective_total, rel=0.01)
    assert est.peak_bytes == pytest.approx(full.peak_bytes, rel=0.25)
