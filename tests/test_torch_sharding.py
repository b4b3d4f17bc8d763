"""The port's sharding rules against the reference's, on the CPU.

Resolution reads only the mesh's axis sizes, so both packages get a
stand-in mesh (an object whose ``.shape`` maps axis names to sizes) at
the production shapes, 16x16 and 2x16x16, with no device at all.  For
every arch of the zoo at its full config, under both policies, every
port parameter's spec equals the reference's ``spec_for_path`` for its
stacked leaf (``layers.3.attn.wq`` against ``['layers']['attn']['wq']``)
with the layer entry dropped; and ``batch_specs``, ``cache_specs``
(``heads`` and ``seq``) and ``activation_rules`` equal the reference's
on every cell's inputs.
"""

import functools
import types

import jax
import pytest

from repro.configs import ARCH_IDS as REF_ARCH_IDS, SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import steps as RS
from repro.parallel import sharding as RSH

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _mesh(name: str):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _policies(mesh_name: str, mode: str):
    if mesh_name == "2x16x16":
        return SH.multi_pod_policy(mode), RSH.multi_pod_policy(mode)
    return SH.ShardingPolicy(mode=mode), RSH.ShardingPolicy(mode=mode)


def _spec(p) -> tuple:
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch: str) -> dict:
    """``{keystr: shape}`` of the reference's full-config parameters."""
    tree = RS.abstract_params(ref_get_config(arch))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in leaves}


def test_zoo_lists_match():
    assert ARCH_IDS == REF_ARCH_IDS
    assert list(SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["fsdp_tp", "tp_only"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mode, mesh_name):
    cfg = get_config(arch)
    mesh = _mesh(mesh_name)
    policy, ref_policy = _policies(mesh_name, mode)
    ref = _ref_leaves(arch)
    shapes = M.param_shapes(cfg)
    seen = set()
    for name, shape in shapes.items():
        path = SH.reference_path(name)
        assert path in ref, (name, path)
        stacked = name.split(".", 1)[0] in ("layers", "ssm_layers",
                                            "enc_layers", "dec_layers")
        ref_shape = ref[path]
        want = _spec(RSH.spec_for_path(path, ref_shape, ref_policy, mesh))
        got = SH.spec_for_path(name, shape, policy, mesh)
        if stacked:
            assert ref_shape[1:] == shape, name
            # the layer entry is always None where the rule shards anything
            assert not want or want[0] is None, (name, want)
            want = want[1:]
        else:
            assert ref_shape == shape, name
        assert got == want, (name, got, want)
        seen.add(path)
    assert seen == set(ref)


def _named_specs(tree_specs) -> dict:
    """A reference pytree of NamedShardings as ``{keystr: spec}``."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree_specs, is_leaf=lambda x: hasattr(x, "spec"))
    return {jax.tree_util.keystr(p): _spec(s.spec) for p, s in leaves}


@pytest.fixture
def ref_named_sharding(monkeypatch):
    """The reference's ``batch_specs`` / ``cache_specs`` build
    NamedShardings, which a stand-in mesh cannot make: they are called
    with ``NamedSharding`` swapped for a record of the spec."""
    monkeypatch.setattr(RSH, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))


def _ref_inputs(arch: str, shape: str):
    return RS.input_specs(ref_get_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_reference(arch, mesh_name, ref_named_sharding):
    cfg = get_config(arch)
    mesh = _mesh(mesh_name)
    policy, ref_policy = _policies(mesh_name, "fsdp_tp")
    for shape in SHAPES:
        ref_in = _ref_inputs(arch, shape)
        port_in = S.input_specs(cfg, SHAPES[shape])
        if SHAPES[shape].kind == "decode":
            ref_in = {"tokens": ref_in["tokens"], "pos": ref_in["pos"]}
            port_in = {"tokens": port_in["tokens"], "pos": port_in["pos"]}
        else:
            ref_in, port_in = ref_in["batch"], port_in["batch"]
        want = _named_specs(RSH.batch_specs(ref_policy, mesh, ref_in))
        got = SH.batch_specs(policy, mesh, port_in)
        assert {SH.reference_path(k): v for k, v in got.items()} == want


@pytest.mark.parametrize("cache_shard", ["heads", "seq"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, shape, cache_shard,
                                     ref_named_sharding):
    cfg = get_config(arch)
    for mesh_name in MESHES:
        mesh = _mesh(mesh_name)
        policy, ref_policy = _policies(mesh_name, "fsdp_tp")
        ref_cache = _ref_inputs(arch, shape)["cache"]
        port_cache = S.input_specs(cfg, SHAPES[shape])["cache"]
        want = _named_specs(RSH.cache_specs(ref_policy, mesh, ref_cache,
                                            cache_shard=cache_shard))
        got = SH.cache_specs(policy, mesh, port_cache,
                             cache_shard=cache_shard)
        assert {SH.reference_path(k): v for k, v in got.items()} == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["fsdp_tp", "tp_only"])
def test_activation_rules_equal_reference(mode, mesh_name):
    policy, ref_policy = _policies(mesh_name, mode)
    assert SH.activation_rules(policy) == RSH.activation_rules(ref_policy)


# tests/test_models.py's rule cases (on a 1x1 mesh) and the production
# fallbacks: (shape, tokens or a path, mesh)
FALLBACK_CASES = [
    ((28, 2048, 4, 128), (None, "fsdp", "tp", None), "1x1"),
    ((3, 7), ("fsdp", "tp"), "1x1"),
    ((2, 64, 4, 16), "['layers']['attn']['wq']", "1x1"),
    ((512, 64), "['embed']['tok']", "1x1"),
    ((64,), "['final_norm']", "1x1"),
    # 4 kv heads cannot shard a 16-way model axis: replicated
    ((28, 2048, 4, 128), (None, "fsdp", "tp", None), "16x16"),
    ((28, 2048, 8, 128), "['layers']['attn']['wk']", "16x16"),
    ((28, 2048, 16, 128), "['layers']['attn']['wq']", "16x16"),
    ((3, 7), ("fsdp", "tp"), "16x16"),
    ((151936, 2048), "['embed']['tok']", "2x16x16"),
    ((64, 2048, 1024, 16), "['layers']['moe']['wi_gate']", "2x16x16"),
    ((28, 2048), ("fsdp",), "2x16x16"),
    ((5,), None, "16x16"),
]


@pytest.mark.parametrize("shape,rule,mesh_name", FALLBACK_CASES)
def test_resolution_and_divisibility_fallback(shape, rule, mesh_name):
    sizes = ({"data": 1, "model": 1} if mesh_name == "1x1"
             else MESHES[mesh_name])
    mesh = types.SimpleNamespace(shape=dict(sizes))
    policy, ref_policy = _policies(mesh_name, "fsdp_tp")
    if isinstance(rule, str):
        got = SH.spec_for_path(rule, shape, policy, mesh)
        want = RSH.spec_for_path(rule, shape, ref_policy, mesh)
    else:
        got = SH.resolve_spec(shape, rule, policy, mesh)
        want = RSH.resolve_spec(shape, rule, ref_policy, mesh)
    assert got == _spec(want)


@pytest.mark.parametrize("spec,want", [
    ((None, "data", "model", None), ["R", "S1", "S2"]),
    ((("pod", "data"), "model"), ["S0", "S0", "S1"]),
    (("model", ("pod", "data")), ["S1", "S1", "S0"]),
    ((), ["R", "R", "R"]),
])
def test_placements_of_a_spec(spec, want):
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = ["R" if p.is_replicate() else f"S{p.dim}"
           for p in SH.placements(spec, mesh)]
    assert got == want


def test_reference_path_drops_layer_indices():
    assert SH.reference_path("layers.3.attn.wq") == \
        "['layers']['attn']['wq']"
    assert SH.reference_path("opt.m.ssm_layers.0.ssm.in_proj") == \
        "['opt']['m']['ssm_layers']['ssm']['in_proj']"
    assert SH.reference_path("shared_attn.ffn.wo") == \
        "['shared_attn']['ffn']['wo']"


class _StandInMesh:
    """The sizes of a mesh and one rank's coordinates on it."""

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, mesh_dim):
        return self.coord[mesh_dim]


@pytest.mark.parametrize("spec", [(None, "data", "model", None),
                                  (("pod", "data"), "model"),
                                  ("model", ("pod", "data")), ()])
def test_local_shards_tile_the_tensor_in_dtensor_order(spec):
    """``local_shard`` over every coordinate of a 2 x 2 x 3 mesh: each
    rank's shard is DTensor's (a dimension sharded on two mesh dimensions
    chunked by the first, then the second), contiguous; a shard that is
    the whole tensor is the tensor itself."""
    import itertools

    import torch
    names = ("pod", "data", "model")
    sizes = (2, 2, 3)
    t = torch.arange(12 * 12 * 6, dtype=torch.float32).reshape(12, 12, 6)
    pl = SH.placements(spec, types.SimpleNamespace(mesh_dim_names=names))
    for coord in itertools.product(*map(range, sizes)):
        want = t
        for i, p in enumerate(pl):
            if p.is_shard():
                want = want.chunk(sizes[i], p.dim)[coord[i]]
        got = SH.local_shard(t, _StandInMesh(sizes, coord), pl)
        assert got.is_contiguous() and torch.equal(got, want), coord
    whole = SH.local_shard(t, _StandInMesh((1, 1, 1), (0, 0, 0)), pl)
    assert whole.data_ptr() == t.data_ptr()
    if any(p.is_shard() for p in pl):
        with pytest.raises(ValueError):
            SH.local_shard(t[:1, :1], _StandInMesh(sizes, (0, 0, 0)), pl)
