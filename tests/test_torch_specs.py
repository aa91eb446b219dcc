"""The port's sharding plan against the reference's, on the CPU: the spec
type and its DTensor placements (`repro_torch.parallel.sharding`), the
mesh builders and the fake world (`launch.mesh`), the parallel context
(`parallel.context`), the spec rules (`models.specs`), ZeRO-1's optimizer
layout (`optim.adamw`) and the elastic plan (`runtime.elastic`).

Every full config is compared on both production meshes' axes and on a
1 x 1 mesh, from shapes alone: the reference's trees come from
`jax.eval_shape`, the port's modules are built on the meta device.  The
reference stacks per-block leaves; the port's per-block leaf takes the
reference's spec with the stacked entries dropped, and those entries are
always replicated.  ZeRO-1 keeps the reference's rule on the port's own
leaves, so where the reference's 'data' lands on a stacked layer dim the
specs differ by design and the bytes per device are held equal
(ROADMAP.md §3).  Mirrors the reference's `tests/test_substrate.py`
ZeRO-1, elastic and divisibility tests.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import api as japi, specs as jspecs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import context as jctx  # noqa: E402
from repro.parallel.sharding import Axes as JAxes  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api, specs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import context, sharding  # noqa: E402
from repro_torch.parallel.sharding import P, Axes  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

ARCHS = list(configs.ARCHS)
# (axes, n_model, axis sizes) of the single-pod, multi-pod and 1 x 1 meshes
MESHES = {
    "single": (("data",), 16, {"data": 16, "model": 16}),
    "multi": (("pod", "data"), 16, {"pod": 2, "data": 16, "model": 16}),
    "local": (("data",), 1, {"data": 1, "model": 1}),
}
# leaves whose ZeRO-1 'data' the reference puts on a stacked layer dim
ZERO1_STACKED_LEAVES = {"phi3-mini-3.8b": 9, "llama4-scout-17b-a16e": 13,
                        "whisper-large-v3": 26}


def _axes(mesh):
    batch, n_model, _ = MESHES[mesh]
    return Axes(batch, "model"), JAxes(batch, "model"), n_model


def _entries(spec) -> tuple:
    """A spec's entries, a 1-axis tuple as its axis (JAX's PartitionSpec
    keeps ('data',) as 'data')."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


_REF = {}


def _ref(arch):
    """The reference's params, DSG state (shapes only) for a full config."""
    if arch not in _REF:
        cfg = jconfigs.get_config(arch)
        key = jax.random.PRNGKey(0)
        params = jax.eval_shape(lambda: japi.init_model(key, cfg))
        dsg = jax.eval_shape(lambda p: japi.init_dsg(key, p, cfg), params)
        _REF[arch] = (cfg, params, dsg)
    return _REF[arch]


_PORT = {}


def _port(arch):
    """The port's module and DSG state on the meta device."""
    if arch not in _PORT:
        cfg = configs.get_config(arch)
        model = api.init_model(cfg, generator=None, device="meta")
        dsg = api.init_dsg(model, cfg, generator=None, device="meta")
        _PORT[arch] = (cfg, model, dsg)
    return _PORT[arch]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local_numel(shape, spec, sizes) -> int:
    """Elements of one device's shard: each sharded dim divided by the
    product of its axes' sizes (every sharded dim divides exactly)."""
    n = 1
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, e in zip(shape, entries):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        div = math.prod(sizes[a] for a in names)
        assert dim % div == 0, (shape, spec)
        n *= dim // div
    return n


# ---------------------------------------------------------------------------
# the spec type and its placements
# ---------------------------------------------------------------------------

def test_spec_type_builds_and_compares_like_a_partition_spec():
    from jax.sharding import PartitionSpec as JP
    assert P("data", None) == P("data", None) != P(None, "data")
    assert P() == () and len(P(None, "model", None)) == 3
    assert _entries(P(("pod", "data"), None, "model")) == _entries(
        JP(("pod", "data"), None, "model"))
    assert repr(P("data", None)) == "P('data', None)"
    assert sharding.with_layer_dim(P("model", None)) == P(None, "model", None)
    ax = Axes(("pod", "data"), "model")
    jax_ = JAxes(("pod", "data"), "model")
    from repro.parallel import sharding as jsh
    for name in ("act_bsd", "tokens_bs", "embed_spec", "head_proj_spec",
                 "o_proj_spec", "ffn_col_spec", "ffn_row_spec",
                 "expert_col_spec", "expert_row_spec", "dsg_fw_spec",
                 "dsg_fw_expert_spec"):
        assert _entries(getattr(sharding, name)(ax)) == _entries(
            getattr(jsh, name)(jax_)), name
    for seq in (False, True):
        assert _entries(sharding.kv_cache_spec(ax, seq)) == _entries(
            jsh.kv_cache_spec(jax_, seq))
    assert _entries(sharding.replica_stack_spec()) == _entries(
        jsh.replica_stack_spec())
    assert sharding.replicated() == P()


def test_placements_shard_each_named_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    with tmesh.fake_world(512):
        mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert sharding.placements(mesh, P(("pod", "data"), None, "model")) \
            == [Shard(0), Shard(0), Shard(2)]
        assert sharding.placements(mesh, P(None, "model")) == [
            Replicate(), Replicate(), Shard(1)]
        assert sharding.placements(mesh, P()) == [Replicate()] * 3
        assert sharding.local_shape((2048, 8192), mesh,
                                    P(("pod", "data"), "model")) == (64, 512)
        with pytest.raises(ValueError, match="lacks"):
            sharding.placements(mesh, P("replicas"))
        with pytest.raises(ValueError, match="order"):
            sharding.placements(mesh, P(("data", "pod")))
        with pytest.raises(ValueError, match="twice"):
            sharding.placements(mesh, P("model", "model"))
    assert not torch.distributed.is_initialized()


def test_distribute_gives_the_local_shard_of_a_meta_tensor():
    with tmesh.fake_world(256):
        mesh = tmesh.make_production_mesh(device_type="cpu")
        t = torch.empty(2048, 8192, dtype=torch.bfloat16, device="meta")
        d = sharding.distribute(t, mesh, P(None, "model"))
        assert d.shape == (2048, 8192)
        assert d.to_local().shape == (2048, 512) and d.to_local().is_meta
        d = sharding.distribute(t, mesh, P("data", "model"))
        assert d.to_local().shape == (128, 512)
        # uneven: the first shards are the larger ones, as torch.chunk
        d = sharding.distribute(torch.empty(7, 3, device="meta"), mesh,
                                P("data"))
        assert d.to_local().shape == (1, 3)


# ---------------------------------------------------------------------------
# meshes and the fake world
# ---------------------------------------------------------------------------

def test_mesh_builders_lay_out_the_first_ranks():
    with tmesh.fake_world(512):
        single = tmesh.make_production_mesh(device_type="cpu")
        assert single.mesh_dim_names == ("data", "model")
        assert tuple(single.mesh.shape) == (16, 16)
        multi = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert multi.mesh_dim_names == ("pod", "data", "model")
        assert tuple(multi.mesh.shape) == (2, 16, 16) and multi.size() == 512
        assert sharding.data_shards(multi) == 32
        assert sharding.model_shards(multi) == 16
        local = tmesh.make_local_mesh(device_type="cpu")
        assert tuple(local.mesh.shape) == (1, 1) and local.size() == 1
        el = tmesh.make_elastic_mesh(300, 16, device_type="cpu")
        assert tuple(el.mesh.shape) == (18, 16)
        assert el.mesh.flatten().tolist() == list(range(288))
        with pytest.raises(ValueError):
            tmesh.make_elastic_mesh(8, 16, device_type="cpu")
        rep = sharding.replica_mesh(3, device_type="cpu")
        assert rep.mesh_dim_names == ("replicas",) and rep.size() == 3
    with tmesh.fake_world(100):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="needs 101 devices"):
            sharding.replica_mesh(101, device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_fake_world_refuses_a_live_group_and_cleans_up():
    with tmesh.fake_world(4):
        assert torch.distributed.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already set up"):
            with tmesh.fake_world(2):
                pass
        assert torch.distributed.is_initialized()
    assert not torch.distributed.is_initialized()
    with pytest.raises(KeyError):
        with tmesh.fake_world(2):
            raise KeyError("inside")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the parallel context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    ((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model"))])
def test_context_agrees_with_the_reference(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    jmesh = AbstractMesh(shape, names)
    with tmesh.fake_world(math.prod(shape)):
        mesh = DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(
            shape), mesh_dim_names=names)
        assert context.current() is None and context.batch_axes() is None
        for shardable in (True, False):
            with context.use_mesh(mesh, shardable) as ctx, \
                    jctx.use_mesh(jmesh, shardable) as jc:
                assert tuple(ctx.ax) == tuple(jc.ax)
                assert ctx.n_model == jc.n_model
                assert context.batch_axes() == jctx.batch_axes()
                for mode in ("auto", "head", "seq"):
                    for heads in (1, 8, 16, 24, 32, 40, 64):
                        assert context.resolve_attn_shard(mode, heads) == \
                            jctx.resolve_attn_shard(mode, heads)
                for n in (0, 1, 8, 16, 24, 48, 256, 1000):
                    assert context.divisible(n) == jctx.divisible(n)
            assert context.current() is None
        with context.use_mesh(None) as ctx:
            assert ctx is None and context.resolve_attn_shard(
                "auto", 16) == "none" and not context.divisible(16)


def test_constrain_redistributes_a_dtensor_and_passes_the_rest():
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(16.0).reshape(4, 4)
    assert context.constrain(x, "data", None) is x          # no context
    with tmesh.fake_world(4):
        mesh = tmesh.make_elastic_mesh(4, 2, device_type="cpu")   # (2, 2)
        local = tmesh.make_local_mesh(device_type="cpu")
        d = sharding.distribute(x, mesh, P())
        with context.use_mesh(mesh):
            assert context.constrain(x, "data", None) is x   # plain tensor
            out = context.constrain(d, "data", None)
            assert list(out.placements) == [Shard(0), Replicate()]
            assert out.to_local().shape == (2, 4)
            assert torch.equal(out.to_local(), x[:2])
        with context.use_mesh(local):
            assert context.constrain(d, "data", None) is d   # 1-device mesh


# ---------------------------------------------------------------------------
# the spec rules against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_dsg_specs_equal_the_reference(arch, mesh):
    ax, jax_, n_model = _axes(mesh)
    jcfg, jparams, jdsg = _ref(arch)
    cfg, model, dsg = _port(arch)
    jps = jspecs.param_specs(jparams, jcfg, jax_, n_model)
    ps = specs.param_specs(model, cfg, ax, n_model)
    assert list(ps) == [n for n, _ in model.named_parameters()]
    for name, spec in ps.items():
        path, idx = bridge.reference_path(name)
        want = _entries(_get(jps, path))
        if want:
            assert all(e is None for e in want[:len(idx)]), (name, want)
            want = want[len(idx):]
        assert _entries(spec) == want, (name, spec, want)
    jds = jspecs.dsg_specs(jdsg, jcfg, jax_, n_model)
    ds = specs.dsg_specs(dsg, cfg, ax, n_model)
    assert set(ds) == set(jds)
    for k in ds:
        assert _entries(ds[k]) == _entries(jds[k]), k


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_the_reference(arch, mesh):
    ax, jax_, n_model = _axes(mesh)
    jcfg = jconfigs.get_config(arch)
    cfg = configs.get_config(arch)
    jcache = jax.eval_shape(lambda: japi.make_cache(jcfg, 32, 2048))
    cache = api.make_cache(cfg, 32, 2048, device="meta")
    jcs = jspecs.cache_specs(jcache, jcfg, jax_, n_model)
    cs = specs.cache_specs(cache, cfg, ax, n_model)
    assert (cs is None) == (jcs is None)
    for k in cs or {}:
        assert tuple(cache[k].shape) == jcache[k].shape
        assert _entries(cs[k]) == _entries(jcs[k]), k
    for jshape in JSHAPES:
        shape = configs.shape_by_name(jshape.name)
        jins = japi.make_inputs(jcfg, jshape)
        ins = api.make_inputs(cfg, shape)
        jis = jspecs.input_specs(jins, jcfg, jax_)
        is_ = specs.input_specs(ins, cfg, ax)
        assert set(is_) == set(jis)
        for k in is_:
            assert tuple(ins[k].shape) == jins[k].shape
            assert _entries(is_[k]) == _entries(jis[k]), (jshape.name, k)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b",
                                  "whisper-large-v3"])
def test_decode_state_specs_equal_the_reference(arch):
    """The recurrent and encoder-decoder decode states (what a prefill
    leaves) at smoke width: the same leaves and specs."""
    ax, jax_, n_model = _axes("single")
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    shape = configs.ShapeConfig("p", 32, 2, "prefill")
    jshape = jconfigs.base.ShapeConfig("p", 32, 2, "prefill")
    key = jax.random.PRNGKey(0)
    jparams = japi.init_model(key, jcfg)
    jdsg = japi.init_dsg(key, jparams, jcfg)
    jstate = jax.eval_shape(
        lambda p, d, i, c: japi.prefill(p, d, jcfg, i, c)[1], jparams, jdsg,
        japi.make_inputs(jcfg, jshape),
        jax.eval_shape(lambda: japi.make_cache(jcfg, 2, 32)))
    model = bridge.model_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    dsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, jdsg), device="cpu")
    state = api.prefill(model, dsg, cfg, api.make_inputs(
        cfg, shape, concrete=True, device="cpu"),
        api.make_cache(cfg, 2, 32, device="cpu"))[1]
    jst = jspecs.cache_specs(jstate, jcfg, jax_, n_model)
    st = specs.cache_specs(state, cfg, ax, n_model)
    flat = jax.tree_util.tree_flatten_with_path(
        jst, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    seen = 0
    for path, jspec in flat:
        keys = [getattr(k, "key", None) for k in path]
        spec = _get(st, keys)
        assert tuple(_get(state, keys).shape) == _get(jstate, keys).shape
        assert _entries(spec) == _entries(jspec), keys
        seen += 1
    assert seen == sum(1 for _ in _spec_leaves(st))


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible(arch, mesh):
    """Every sharded dim of every port parameter divides its mesh axes:
    the static proof that the full configs lay out on the production
    meshes (the reference's `test_param_specs_divisible`, on the port's
    per-block leaves)."""
    ax, _, n_model = _axes(mesh)
    sizes = MESHES[mesh][2]
    cfg, model, _ = _port(arch)
    ps = specs.param_specs(model, cfg, ax, n_model)
    for name, p in model.named_parameters():
        for dim, entry in zip(p.shape, ps[name]):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            total = math.prod(sizes[n] for n in names)
            assert dim % total == 0, (arch, name, tuple(p.shape), ps[name])


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

def test_zero1_specs_add_data_axis():
    ps = {"a": P(None, "model"), "b": P()}
    params = {"a": torch.zeros((32, 64)), "b": torch.zeros((7,))}
    zs = adamw.zero1_specs(ps, params)
    assert zs["a"] == P("data", "model")
    assert zs["b"] == P()          # 7 not divisible -> untouched
    st = adamw.opt_specs_with_master(ps, params)
    assert set(st) == {"step", "m", "v", "master"} and st["step"] == P()
    assert st["master"] == st["m"] == st["v"] == zs
    assert adamw.opt_specs(ps, params, zero1=False)["m"] == ps


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_bytes_per_device_equal_the_reference(arch, mesh):
    """The optimizer state with f32 masters has the reference's bytes per
    device (its 4-byte step counter aside: the port keeps the step on the
    host).  Where the specs differ, the reference's 'data' sits on a
    stacked layer dim and the port's on the leaf's own first dim that 16
    divides; nothing else differs."""
    ax, jax_, n_model = _axes(mesh)
    sizes = MESHES[mesh][2]
    jcfg, jparams, _ = _ref(arch)
    cfg, model, _ = _port(arch)
    params = dict(model.named_parameters())
    jst = jadamw.opt_specs_with_master(
        jspecs.param_specs(jparams, jcfg, jax_, n_model), jparams)
    st = adamw.opt_specs_with_master(
        specs.param_specs(model, cfg, ax, n_model), params)
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [k.key for k in path]
        want += _local_numel(leaf.shape, _get(jst["m"], keys), sizes) * 4
    got = sum(_local_numel(p.shape, st["m"][n], sizes) * 4
              for n, p in params.items())
    assert got == want
    assert st["v"] == st["m"] == st["master"]
    stacked = set()
    for name, spec in st["m"].items():
        path, idx = bridge.reference_path(name)
        jspec = _entries(_get(jst["m"], path))
        jspec = jspec + (None,) * (len(idx) + params[name].ndim - len(jspec))
        if _entries(spec) + (None,) * (params[name].ndim - len(spec)) \
                == jspec[len(idx):]:
            continue
        # the reference's 'data' on a stacked dim, the port's on its own
        assert "data" in jspec[:len(idx)], (name, spec, jspec)
        own = [i for i, e in enumerate(spec) if e == "data"]
        assert len(own) == 1, (name, spec)
        rest = list(spec) + [None] * (params[name].ndim - len(spec))
        rest[own[0]] = None
        assert tuple(rest) == jspec[len(idx):], (name, spec, jspec)
        stacked.add(path)
    assert len(stacked) == ZERO1_STACKED_LEAVES.get(arch, 0), sorted(stacked)


# ---------------------------------------------------------------------------
# the elastic plan
# ---------------------------------------------------------------------------

def test_elastic_plan():
    p = elastic.plan_after_loss(512 - 16, model=16)   # lost one 16-chip host
    assert p.model == 16 and p.data == 16 and p.n_devices == 256
    assert p.dropped == 240 and p.scale == pytest.approx(256 / 496)
    p2 = elastic.plan_after_loss(300, model=16)
    assert p2.data == 16
    with pytest.raises(RuntimeError):
        elastic.plan_after_loss(8, model=16)


@pytest.mark.parametrize("model", [8, 16])
def test_elastic_plan_equals_the_reference(model):
    for n in range(1, 601):
        try:
            want = jelastic.plan_after_loss(n, model=model)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="cannot keep"):
                elastic.plan_after_loss(n, model=model)
            assert str(e).startswith("cannot keep")
            continue
        got = elastic.plan_after_loss(n, model=model)
        assert (got.n_devices, got.data, got.model, got.dropped) == (
            want.n_devices, want.data, want.model, want.dropped), n
        assert got.scale == want.scale
