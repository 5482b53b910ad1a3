"""The kernels' plain versions run per rank on DTensor shards
(``distributed/shard_kernels.py``, the dry-run's attention and expert
products, under ``per_shard``) against the plain versions on whole tensors,
with real values: four CPU processes in a gloo group on a 2x2 ("data",
"model") mesh. GQA
whose KV heads do not divide the model axis (each rank takes its query
heads' KV heads from a replica, their gradients summed back), decode over a
cache whose positions are split over "model" (the ranks' partial softmax
merged), the grouped matmul and its gradients on EP and TP layouts, and
the SSD scan and its backward on the batch rows and heads."""
import os
import socket
import subprocess
import sys
import pathlib

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_WORKER = r'''
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor, Replicate, Shard
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.shard_kernels import per_shard
from repro_torch.kernels.common import plain
from repro_torch.kernels.decode_attention import ref as da
from repro_torch.kernels.flash_attention import ref as fa
from repro_torch.kernels.mamba_scan import ref as ssd
from repro_torch.kernels.moe_gmm import ref as gm
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
g = torch.Generator().manual_seed(0)
rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
dt = lambda t, *pl: distribute_tensor(t, mesh, list(pl))
R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
err = {}
with sh.use_mesh(mesh), per_shard():
    # GQA, 4 query heads over model=2, one KV head (replicated): forward, LSE, backward
    q, k, v, dout = rnd(4, 8, 4, 16), rnd(4, 8, 1, 16), rnd(4, 8, 1, 16), rnd(4, 8, 4, 16)
    for causal, window in ((True, 0), (True, 3), (False, 0)):
        kw = dict(causal=causal, window=window)
        qd, kd, vd, gd = dt(q, S0, S2), dt(k, S0, R), dt(v, S0, R), dt(dout, S0, S2)
        out = plain(fa.mha_reference, qd, kd, vd, **kw).full_tensor()
        err["flash", causal, window] = (out - fa.mha_reference(q, k, v, **kw)).abs().max()
        lse = plain(fa.lse_reference, qd, kd, **kw).full_tensor()
        err["lse", causal, window] = (lse - fa.lse_reference(q, k, **kw)).abs().max()
        got = [t.full_tensor() for t in plain(fa.mha_backward_reference, qd, kd, vd, gd, **kw)]
        want = fa.mha_backward_reference(q, k, v, dout, **kw)
        err["flash_bwd", causal, window] = max((a - b).abs().max() for a, b in zip(got, want))
    # decode over a cache whose 32 positions are split over model, and one whose heads are
    q, kc, vc = rnd(4, 4, 16), rnd(4, 32, 2, 16), rnd(4, 32, 2, 16)
    lens = torch.tensor([1, 17, 32, 40], dtype=torch.int32)
    for heads in (False, True):
        for window in (0, 5):
            cp = (S0, S2) if heads else (S0, S1)
            out = plain(da.decode_attention_reference, dt(q, S0, R), dt(kc, *cp), dt(vc, *cp),
                        dt(lens, S0, R), window=window).full_tensor()
            want = da.decode_attention_reference(q, kc, vc, lens, window=window)
            err["decode", heads, window] = (out - want).abs().max()
    # the grouped matmul: EP (16 experts over model) and TP (6 experts, f over model)
    for E, wp in ((16, (R, S0)), (6, (R, S2))):
        x, w, gr = rnd(E, 8, 12), rnd(E, 12, 10), rnd(E, 8, 10)
        xd, wd, gd = dt(x, R, R), dt(w, *wp), dt(gr, R, R)
        err["gmm", E] = (plain(gm.gmm_reference, xd, wd).full_tensor()
                         - gm.gmm_reference(x, w)).abs().max()
        err["gmm_dx", E] = (plain(gm.gmm_dx_reference, gd, wd).full_tensor()
                            - gm.gmm_dx_reference(gr, w)).abs().max()
        err["gmm_dw", E] = (plain(gm.gmm_dw_reference, xd, gd).full_tensor()
                            - gm.gmm_dw_reference(x, gr)).abs().max()
# the plain versions compute in fp32 whatever their inputs: 1e-5 holds a
# different order of the same fp32 sums (dk, dv summed over a KV head's
# query heads on several ranks), and no wrong shard or merge
    # the SSD scan and its backward, 4 heads over model, a ragged last chunk
    x, dtv, Bm, Cm, dy = rnd(4, 70, 4, 8), rnd(4, 70, 4).abs() * 0.1, rnd(4, 70, 6), \
        rnd(4, 70, 6), rnd(4, 70, 4, 8)
    A, Dv, init = -rnd(4).abs(), rnd(4), rnd(4, 4, 8, 6)
    args = (dt(x, S0, S2), dt(dtv, S0, S2), dt(A, R, S0), dt(Bm, S0, R), dt(Cm, S0, R),
            dt(Dv, R, S0))
    for st in (None, init):
        sd = None if st is None else dt(st, S0, S1)
        got = [t.full_tensor() for t in plain(ssd.ssd_chunked_reference, *args, sd)]
        want = ssd.ssd_chunked_reference(x, dtv, A, Bm, Cm, Dv, st)
        err["ssd", st is None] = max((a - b).abs().max() for a, b in zip(got, want))
        got = [t.full_tensor() for t in plain(ssd.ssd_backward_reference, *args, sd,
                                                dt(dy, S0, S2))]
        want = ssd.ssd_backward_reference(x, dtv, A, Bm, Cm, Dv, st, dy)
        err["ssd_bwd", st is None] = max((a - b).abs().max() for a, b in zip(got, want))
bad = {k: float(v) for k, v in err.items() if not v < 1e-5}
print(rank, len(err), bad, flush=True)
dist.destroy_process_group()
sys.exit(1 if bad else 0)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_shard_kernels_match_the_plain_versions_on_four_ranks():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, errs) in zip(procs, outs):
        assert p.returncode == 0, (out, errs[-3000:])
        assert out.split()[1] == "23", out            # every check ran
