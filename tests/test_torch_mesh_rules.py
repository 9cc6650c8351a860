"""The port's mesh rules against the JAX package's, in-process and with no
process group: nothing here initialises a world, sets ``XLA_FLAGS`` or
builds a device mesh. The spec functions read only a mesh's axis names and
sizes, so both sides take duck-typed meshes (``tests/test_shardings.py``'s
``_FakeMesh``) or, where the reference builds a ``NamedSharding``,
``jax.sharding.AbstractMesh``.

* ``spec_for``/``make_pspecs`` for every ``ParamDef`` of the ten configs'
  ``model_defs`` under the tp, fsdp and fsdp_sp profiles on the meshes
  (16, 16), (2, 16, 16), (4, 2) and (1, 8); ``make_shardings``' placements
  follow the specs;
* ``rules_for_profile``, ``batch_spec``, the elastic mesh's shapes and
  ``shard_act``'s specs;
* ``state_shardings``' specs for every config's decode state;
* the expert-parallel dispatch: the port's ``_dispatch_group_ep`` against
  the reference's for each rank's expert slice, on the reference's MoE
  test config (8 experts, top-2, 2 shared, capacity factor 8.0, group 16),
  and the slices' sum against ``_dispatch_group``. Tolerance at fp32:
  rtol = atol = 1e-5 (the k choices and the ranks' partials are added in
  other orders; measured ≤ 1.2e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import shardings as jsh
from repro.models import base as jbase
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.models import base, moe, transformer

EP_TOL = dict(rtol=1e-5, atol=1e-5)


class _FakeMesh:
    """Duck-typed mesh: the spec functions only touch .axis_names and .shape."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _axes_of(shape: tuple) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


MESHES = [(16, 16), (2, 16, 16), (4, 2), (1, 8)]
PROFILES = ["tp", "fsdp", "fsdp_sp"]


def _fake(shape: tuple) -> _FakeMesh:
    return _FakeMesh(dict(zip(_axes_of(shape), shape)))


def _abstract(shape: tuple) -> AbstractMesh:
    return AbstractMesh(tuple(shape), _axes_of(shape))


def _flat(tree, path=()):
    """Leaves of nested dicts with their key paths, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], (*path, k))]
    return [(path, tree)]


def _flat_like(like, tree):
    """The leaves of ``tree`` where ``like`` (a decode state: dicts and
    tuples of tensors) has its leaves."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flat_like(like[k], tree[k])]
    if isinstance(like, tuple):
        return [x for a, b in zip(like, tree) for x in _flat_like(a, b)]
    return [tree]


def _ref_specs(tree):
    """The reference's tree of PartitionSpec/NamedSharding as (path, tuple)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        spec = leaf.spec if hasattr(leaf, "spec") else leaf
        out.append((tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path), tuple(spec)))
    return out


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", PROFILES)
def test_rules_for_profile_match_reference(profile):
    assert base.rules_for_profile(profile) == jbase.rules_for_profile(profile)
    for name in ("LOGICAL_RULES", "FSDP_RULES", "ACT_RULES", "FSDP_ACT_RULES", "FSDP_SP_ACT_RULES"):
        assert getattr(base, name) == getattr(jbase, name), name


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_reference(arch, profile, mesh_shape):
    rules, _, _ = base.rules_for_profile(profile)
    jrules, _, _ = jbase.rules_for_profile(profile)
    mesh = _fake(mesh_shape)
    defs, jdefs = transformer.model_defs(configs.get(arch)), jtf.model_defs(jconfigs.get(arch))
    got = _flat(base.make_pspecs(defs, mesh, rules))
    want = _ref_specs(jbase.make_pspecs(jdefs, mesh, jrules))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [s for _, s in got] == [s for _, s in want]
    # spec_for leaf by leaf, and the placements that make_shardings gives
    placements = dict(_flat(base.make_shardings(defs, mesh, rules)))
    names = list(mesh.axis_names)
    for (path, d), (_, spec) in zip(_flat(defs), got):
        assert base.spec_for(d, mesh, rules) == spec
        pl = placements[path]
        assert len(pl) == len(names)
        for i, a in enumerate(names):
            dims = [k for k, e in enumerate(spec) if e == a or (isinstance(e, tuple) and a in e)]
            if dims:
                assert pl[i].is_shard() and pl[i].dim == dims[0], (path, spec, pl)
                assert d.shape[dims[0]] % mesh.shape[a] == 0
            else:
                assert pl[i].is_replicate(), (path, spec, pl)


def test_reference_spec_cases():
    """``tests/test_shardings.py``'s cases through the port."""
    mesh, mesh_mp = _fake((16, 16)), _fake((2, 16, 16))
    pd = base.ParamDef
    assert base.spec_for(pd((1024, 2816), ("embed", "mlp")), mesh) == ("data", "model")
    assert base.spec_for(pd((1280, 504), ("embed", "vocab")), mesh) == ("data", None)
    assert list(base.spec_for(pd((64, 128, 256), ("experts", "mlp", "heads")), mesh)).count("model") == 1
    fsdp, _, _ = base.rules_for_profile("fsdp")
    assert base.spec_for(pd((1024, 2816), ("embed", "mlp")), mesh, fsdp) == (("data", "model"), None)
    assert base.spec_for(pd((151936, 1024), ("vocab", "embed")), mesh, fsdp) == (None, ("data", "model"))
    assert base.spec_for(pd((88, 6144, 24576), ("layers", "embed", "mlp")), mesh)[0] is None
    assert sh.batch_spec(mesh_mp, (256,), ("pod", "data")) == (("pod", "data"),)
    assert sh.batch_spec(mesh_mp, (1,), ("pod", "data")) == ()
    assert sh.batch_spec(mesh_mp, (256,), ("pod", "data", "model")) == ()


def test_placements_need_mesh_order():
    with pytest.raises(ValueError, match="mesh's axis order"):
        base.placements_for((("model", "data"),), _fake((4, 2)))


# ---------------------------------------------------------------------------
# Batches, the elastic mesh, activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_batch_spec_matches_reference(mesh_shape):
    mesh = _fake(mesh_shape)
    for shape in [(1,), (2, 7), (8, 128), (16, 4), (32, 64, 3), (256,), (512, 2), (0,), ()]:
        for axes in [("pod", "data"), ("pod", "data", "model"), ("data",), ("model",)]:
            assert sh.batch_spec(mesh, shape, axes) == tuple(jsh.batch_spec(mesh, shape, axes)), (shape, axes)


def test_elastic_mesh_shapes_match_reference(monkeypatch):
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    for hosts in range(1, 70):
        for chips in (1, 2, 3, 4, 6, 8):
            want_shape, want_axes = jmesh.make_elastic_mesh(hosts, chips)
            assert mesh_lib.elastic_shape(hosts, chips) == want_shape, (hosts, chips)
            assert want_axes == ("data", "model")


def test_mesh_constructors_need_a_world():
    """No world is initialised in the test process: the constructors refuse,
    and none initialises one through ``env://``."""
    assert not torch.distributed.is_initialized()
    for build in (lambda: mesh_lib.make_host_mesh(device="cpu"),
                  lambda: mesh_lib.make_production_mesh(device="cpu"),
                  lambda: mesh_lib.make_elastic_mesh(2, device="cpu")):
        with pytest.raises(RuntimeError, match="initialised world"):
            build()
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        mesh_lib.make_mesh((1,), ("data",), device="tpu")
    assert not torch.distributed.is_initialized()
    assert mesh_lib.H100_SXM.hbm_bw == 3.35e12 and mesh_lib.H100_SXM.peak_flops == 989e12


ACT_CASES = [
    ((32, 128, 64), ("act_batch", "act_seq", None)),
    ((1, 4096, 64), ("act_batch", "act_seq", None)),
    ((64, 1, 64), ("act_batch", "act_seq", None)),
    ((32, 8, 16, 64), ("act_batch", "act_model", None, None)),
    ((8, 64, 24, 32), ("act_batch", "act_model", None, None)),
    ((32, 256, 16, 64), ("act_batch", None, "act_model", None)),
    ((32, 256, 1, 64), ("act_batch", None, "act_model", None)),
    ((16, 3, 4608), ("act_batch", None, "act_model")),
    ((0, 16, 8), ("act_batch", "act_seq", None)),
    ((512, 2048, 8), ("act_batch", "act_seq", None)),
]


@pytest.mark.parametrize("act", ["ACT_RULES", "FSDP_ACT_RULES", "FSDP_SP_ACT_RULES"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_shard_act_specs_match_reference(monkeypatch, mesh_shape, act):
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)
    amesh, fmesh = _abstract(mesh_shape), _fake(mesh_shape)
    for shape, axes in ACT_CASES:
        with jbase.use_mesh(amesh, getattr(jbase, act)):
            want = tuple(jbase.shard_act(jnp.zeros(shape, jnp.float32), axes).spec)
        got = base.act_spec(shape, axes, fmesh, getattr(base, act))
        assert got == want, (shape, axes)
        with base.use_mesh(fmesh, getattr(base, act)):
            assert base.act_spec(shape, axes) == want
            x = torch.zeros(shape)
            assert base.shard_act(x, axes) is x  # a rank's own block passes unchanged
    assert base.current_mesh() is None


def test_shard_act_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert base.current_mesh() is None
    assert base.shard_act(x, ("act_batch", "act_seq", None)) is x


# ---------------------------------------------------------------------------
# Decode states
# ---------------------------------------------------------------------------

STATE_ARCHS = [a for a in configs.ARCH_NAMES if configs.get(a).family != "audio"]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_specs_match_reference(arch, mesh_shape):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for batch, max_len in ((32, 256), (1, 64), (2, 128)):
        state = transformer.init_state(cfg, batch, max_len, device="meta")
        jstate = jax.eval_shape(lambda: jtf.init_state(jcfg, batch, max_len))
        want = _ref_specs(jsh.state_shardings(jcfg, jstate, _abstract(mesh_shape)))
        got = _flat_like(state, sh.state_specs(cfg, state, _fake(mesh_shape)))
        assert got == [s for _, s in want], (batch, max_len)
        assert len(got) == len(jax.tree.leaves(jstate))


def test_state_shardings_are_placements():
    cfg = configs.get("zamba2-2.7b")
    mesh = _fake((4, 2))
    state = transformer.init_state(cfg, 8, 64, device="meta")
    specs = _flat_like(state, sh.state_specs(cfg, state, mesh))
    pls = _flat_like(state, sh.state_shardings(cfg, state, mesh))
    assert len(specs) == len(pls) == 4
    for spec, pl in zip(specs, pls):
        assert pl == base.placements_for(spec, mesh)


def test_audio_has_no_decode_state():
    with pytest.raises(ValueError, match="no decode state"):
        transformer.init_state(configs.get("hubert-xlarge"), 2, 8, device="meta")


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------


def _moe_pair():
    """The reference's MoE test config (tests/test_distributed.py), its
    weights from PRNGKey(0) and the same as tensors, and x (4, 16, d)."""
    kw = dict(n_experts=8, top_k=2, n_shared_experts=2, capacity_factor=8.0)
    jcfg = dataclasses.replace(jconfigs.get_reduced("deepseek-moe-16b"), **kw)
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **kw)
    jp = jbase.init_params(jax.random.PRNGKey(0), jmoe.moe_defs(jcfg))

    def tree(p):
        return {k: tree(v) for k, v in p.items()} if isinstance(p, dict) else torch.as_tensor(np.array(p))

    x = np.random.default_rng(0).normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, tree(jp), x


@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
def test_ep_partials_match_reference(n_ranks):
    jcfg, jp, cfg, tp, x = _moe_pair()
    n_local = cfg.n_experts // n_ranks
    y_local, aux_local = moe._dispatch_group(tp, torch.as_tensor(x), cfg)
    jy_local, jaux_local = jmoe._dispatch_group(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y_local.numpy(), np.asarray(jy_local), **EP_TOL)
    total = torch.zeros_like(y_local)
    for r in range(n_ranks):
        off = r * n_local
        sl = {"router": tp["router"], **{k: tp[k][off : off + n_local] for k in ("gate", "up", "down")}}
        jsl = {"router": jp["router"], **{k: jp[k][off : off + n_local] for k in ("gate", "up", "down")}}
        y, aux = moe._dispatch_group_ep(sl, torch.as_tensor(x), cfg, off, n_local)
        jy, jaux = jmoe._dispatch_group_ep(jsl, jnp.asarray(x), jcfg, off, n_local)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EP_TOL)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
        assert float(aux) == float(aux_local)  # routing is computed in full on every rank
        total = total + y
    shared = transformer.layers.mlp(tp["shared"], torch.as_tensor(x), "swiglu")
    gap = float((total + shared - y_local).abs().max())
    print(f"EP over {n_ranks} rank(s): sum of partials vs _dispatch_group max |d| {gap:.3e}")
    np.testing.assert_allclose((total + shared).numpy(), y_local.numpy(), **EP_TOL)
    np.testing.assert_allclose((total + shared).numpy(), np.asarray(jy_local), **EP_TOL)
    if n_ranks == 1:  # all experts on one rank: the local path op for op
        assert torch.equal(total + shared, y_local)
