"""The port's sharding layer against the JAX package's: spec sanitizing,
``constrain`` without a mesh, the production meshes on a fake process group,
and every arch's param, cache, optimizer and input spec trees held key by
key against the reference's (``model.init`` under ``jax.eval_shape``, as its
dry-run gets them)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.models import api as jax_api
from repro.train import optimizer as jax_opt
from repro_torch.configs.base import SHAPE_BY_NAME
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api as mapi
from repro_torch.train import optimizer as opt


@pytest.fixture
def group():
    """A fake process group of the size the test asks for, destroyed after
    it (a group is global to the process; the test workers share none)."""
    stack = []

    def make(n):
        cm = mesh_mod.process_group(n)
        cm.__enter__()
        stack.append(cm)
    yield make
    for cm in stack:
        cm.__exit__(None, None, None)


def test_sanitize_spec_divisibility(group):
    group(1)
    with sh.use_mesh(mesh_mod.make_debug_mesh("data", device="cpu")):
        assert sh.sanitize_spec(P("data", None), (12, 7)) == P("data", None)  # size 1 divides
        assert sh.sanitize_spec(P("model", None), (12, 7)) == P(None, None)   # unknown axis


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert sh.current_mesh() is None
    assert sh.constrain(x, "data", None) is x
    assert sh.sanitize_spec(P("data"), (4,)) == P()


def test_constrain_keeps_a_plain_tensor_under_a_mesh(group):
    group(256)
    x = torch.ones(32, 12)
    with sh.use_mesh(mesh_mod.make_production_mesh(device_type="cpu")):
        assert sh.constrain(x, ("pod", "data"), "model") is x
        assert sh.reshape(x, 32, 3, 4).data_ptr() == x.data_ptr()


def test_fused_heads_shard_and_a_head_axis_falls_back(group):
    """The docstring's case: a (12*128) fused-head dim shards over model=16,
    a 12-head axis does not and falls back to replicated."""
    group(256)
    with sh.use_mesh(mesh_mod.make_production_mesh(device_type="cpu")):
        assert sh.sanitize_spec(P(None, "model"), (8, 12 * 128)) == P(None, "model")
        assert sh.sanitize_spec(P(None, "model", None), (8, 12, 128)) == P(None, None, None)
        assert sh.sanitize_spec(P(("pod", "data"), None), (32, 5)) == P("data", None)


@pytest.mark.parametrize("world,multi_pod", [(256, False), (512, False), (512, True)])
def test_production_meshes_on_a_fake_group(group, world, multi_pod):
    from torch.distributed.tensor import Shard
    group(world)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    want = mesh_mod.MULTI_POD if multi_pod else mesh_mod.SINGLE_POD
    assert tuple(mesh.mesh.shape) == want[0] and mesh.mesh_dim_names == want[1]
    assert mesh.mesh.flatten().tolist() == list(range(mesh.mesh.numel()))   # the first ranks
    with sh.use_mesh(mesh):
        assert sh.batch_axes() == (("pod", "data") if multi_pod else ("data",))
        assert sh.axis_size("model") == 16 and sh.axis_size("pod") == (2 if multi_pod else 1)
        spec = P(("pod", "data"), None, "model")
        pl = sh.placements(spec, mesh, (64, 3, 32))
        assert pl == ([Shard(0), Shard(0), Shard(2)] if multi_pod else [Shard(0), Shard(2)])
        assert sh.tree_shardings({"w": spec}, {"w": (64, 3, 32)}) == {"w": pl}
        t = sh.distribute({"w": torch.empty(64, 3, 32, device="meta")}, {"w": spec})["w"]
        assert tuple(t.to_local().shape) == ((2 if multi_pod else 4), 3, 2)


def test_too_few_ranks_raise(group):
    group(4)
    with pytest.raises(RuntimeError, match="launch/dryrun.py"):
        mesh_mod.make_production_mesh(device_type="cpu")


def test_reshape_gathers_only_a_dim_it_cannot_split(group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    group(256)
    mesh = mesh_mod.make_production_mesh(device_type="cpu")
    with sh.use_mesh(mesh):
        for heads, want in ((12, Replicate()), (16, Shard(2))):
            x = distribute_tensor(torch.empty(32, 8, heads * 128, device="meta"), mesh,
                                  [Shard(0), Shard(2)])
            y = sh.reshape(x, 32, 8, heads, 128)
            assert tuple(y.shape) == (32, 8, heads, 128)
            assert y.placements == (Shard(0), want)


def test_kernel_route_takes_meta_to_the_plain_version():
    from repro_torch.kernels.common import kernel_route
    assert kernel_route(torch.empty(2, device="meta"), torch.empty(3, device="meta")) == "cpu"
    with pytest.raises(ValueError):
        kernel_route(torch.empty(2, device="meta"), torch.empty(2))


# ------------------------------------------------ spec trees vs the reference
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _specs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def _records(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("shape", [s.name for s in JSHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_the_reference(arch, shape):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jmodel, box = jax_api.get_model(jcfg), {}

    def initfn(key):
        params, specs = jmodel.init(key, jcfg)
        box["specs"] = specs
        return params
    jshapes = jax.eval_shape(initfn, jax.ShapeDtypeStruct((2,), jnp.uint32))
    pspecs = mapi.param_specs(cfg)
    assert {k: tuple(v) for k, v in pspecs.items()} == _specs(box["specs"])
    assert _records(mapi.param_records(cfg)) == _records(jshapes)
    assert {k: tuple(v) for k, v in mapi.get_model(cfg).cache_specs(cfg).items()} \
        == _specs(jmodel.init_cache(jcfg, 1, 1, jnp.bfloat16)[1])
    assert {k: tuple(v) for k, v in opt.opt_state_specs(pspecs).items()} \
        == _specs(jax_opt.opt_state_specs(box["specs"]))
    jinputs, jspecs = jax_api.input_specs(jcfg, next(s for s in JSHAPES if s.name == shape))
    inputs, specs = mapi.input_specs(cfg, SHAPE_BY_NAME[shape])
    assert _specs(specs) == _specs(jspecs)
    assert _records(inputs) == _records(jinputs)
