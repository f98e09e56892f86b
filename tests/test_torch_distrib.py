"""The port's distribution layer in one process, against the JAX
reference's: the logical-axis table and rule sets, ``placements_for``
against the reference's ``spec_for`` (run with a mesh stub that has
``.shape``) for every parameter leaf of each of the twelve reduced configs
at 2 x 4 and 4 x 2, the port's per-layer tree named as the reference's
stacked one, the resolution rules (a mesh axis once per tensor, a
non-divisible dim replicated, a tuple of axes over one dim), the rules
context, expert routing's tie order and the gradient compression's
rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.distrib import axes as jaxes
from repro.distrib import sharding as jsh
from repro.models.model import Model as JModel
from repro.optim import compression as jcomp
from repro_torch import configs
from repro_torch.distrib import axes as axlib
from repro_torch.distrib import sharding as shlib
from repro_torch.kernels.flash_attention import kv_span
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model
from repro_torch.optim import compression as comp

MESHES = {"2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2}}


def _config_names():
    names = sorted(jconfigs.REGISTRY)
    assert len(names) == 12, names
    return names


class _Stub:
    """A mesh for the reference's ``spec_for``: it reads ``.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _reference_leaves(name):
    cfg = jconfigs.reduced(jconfigs.get(name), repeats=2)
    shapes = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jaxes.path_strings(kp), tuple(x.shape)) for kp, x in flat]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", _config_names())
def test_placements_match_reference_spec_for(name, mesh):
    sizes = MESHES[mesh]
    rules = shlib.tp_dp_rules()
    assert rules == jsh.tp_dp_rules()
    sharded = 0
    for path, shape in _reference_leaves(name):
        names = axlib.logical_axes_for(path, shape)
        assert names == jaxes.logical_axes_for(path, shape), path
        want = tuple(jsh.spec_for(names, shape, _Stub(sizes), rules))
        want += (None,) * (len(shape) - len(want))
        placements = shlib.placements_for(names, shape, sizes, rules)
        assert len(placements) == 2
        assert shlib.spec_of(placements, sizes, len(shape)) == want, path
        assert shlib.resolve(names, shape, sizes, rules) == want, path
        sharded += any(p.is_shard() for p in placements)
    assert sharded > 0


@pytest.mark.parametrize("name", _config_names())
def test_port_tree_is_named_as_the_reference(name):
    """Each leaf of the port's per-layer tree gets the names of the
    reference's stacked leaf at the same key path, less the layer axis."""
    want = {}
    for path, shape in _reference_leaves(name):
        names = jaxes.logical_axes_for(path, shape)
        if path[0] == "groups":             # ("groups", gi, "b{u}", ...)
            want[path[3:]] = names[1:]
        else:
            want[path] = names
    cfg = configs.reduced(configs.get(name), repeats=2)
    params = Model(cfg, device="cpu").init(0)
    for path, x in axlib.leaves_with_paths(params):
        path = axlib.path_strings(path)
        key = path[2:] if path[0] == "layers" else path
        assert axlib.logical_axes_for(path, tuple(x.shape)) == want[key], path


def test_resolution_rules():
    rules = shlib.tp_dp_rules()
    sizes = {"data": 2, "model": 4}
    # smollm's reduced KV heads: 1 does not divide the model axis
    assert shlib.placements_for((None, None, "kv_heads", None), (2, 8, 1, 16),
                                sizes, rules) == (Replicate(), Replicate())
    assert shlib.placements_for((None, None, "heads", None), (2, 8, 4, 16),
                                sizes, rules) == (Replicate(), Shard(2))
    # a mesh axis is used once: vocab after heads both want "model"
    assert shlib.placements_for(("batch", "heads", "vocab"), (2, 4, 8), sizes,
                                rules) == (Shard(0), Shard(1))
    assert shlib.placements_for(("batch", None, "vocab"), (3, 4, 8), sizes,
                                rules) == (Replicate(), Shard(2))
    # a tuple of axes shards one dim over both, outer first
    pod = shlib.tp_dp_rules(pod_axis=True)
    psizes = {"pod": 2, "data": 2, "model": 4}
    got = shlib.placements_for(("batch", None), (8, 3), psizes, pod)
    assert got == (Shard(0), Shard(0), Replicate())
    assert shlib.spec_of(got, psizes, 2) == (("pod", "data"), None)
    assert shlib.spec_of(got, psizes, 2) == tuple(jsh.spec_for(
        ("batch", None), (8, 3), _Stub(psizes), pod))
    with pytest.raises(ValueError, match="mesh's order"):
        shlib.placements_for(("batch",), (8,), psizes,
                             {"batch": ("data", "pod")})
    assert shlib.placements_for(("batch",), (8,)) == ()      # no rules


def test_rule_sets_are_the_reference_values():
    for kw in ({}, {"pod_axis": True}, {"sequence_parallel": True}):
        assert shlib.tp_dp_rules(**kw) == jsh.tp_dp_rules(**kw)
        assert shlib.long_context_rules(**kw) == jsh.long_context_rules(**kw)
    for kvh in (1, 8, 16, 32):
        assert shlib.decode_rules(kv_heads=kvh) == jsh.decode_rules(
            kv_heads=kvh)
    for name, shape in (("tokens", (4, 8)), ("task_ids", (4,)),
                        ("patches", (4, 2, 3)), ("other", (4, 2))):
        assert axlib.batch_axes_for(name, shape) == jaxes.batch_axes_for(
            name, shape)
    for path, shape in ((("0", "b0", "k"), (2, 4, 8, 2, 16)),
                        (("0", "b0", "conv"), (2, 4, 3, 8)),
                        (("0", "b0", "h"), (2, 4, 8)),
                        (("0", "b0", "state"), (2, 4, 8, 8))):
        assert axlib.cache_axes_for(path, shape) == jaxes.cache_axes_for(
            path, shape)


def test_rules_context_is_a_no_op_outside_and_on_plain_tensors():
    x = torch.ones(2, 4, 8)
    assert shlib.constrain(x, "batch", "seq", "embed") is x
    assert shlib.data_group_count() == 1
    with shlib.use_rules({"data": 4, "model": 2}, shlib.tp_dp_rules()):
        assert shlib.constrain(x, "batch", "seq", "embed") is x
        assert shlib.data_group_count() == 4
        with shlib.use_rules({"pod": 2, "data": 2, "model": 2},
                             shlib.tp_dp_rules(pod_axis=True)):
            assert shlib.data_group_count() == 4
        with shlib.use_rules(None, {}):
            assert shlib.data_group_count() == 1
        assert shlib.data_group_count() == 4
    assert shlib.data_group_count() == 1


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    rng = np.random.default_rng(0)
    probs = np.round(rng.random((16, 8)), 1).astype(np.float32)  # ties
    probs[0] = 0.125
    for k in (1, 2, 5):
        v, i = moe_mod.top_k(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("q_off,q_len,g,want", [
    (0, 1, 4, (0, 1)), (3, 1, 4, (0, 1)), (4, 4, 4, (1, 2)),
    (8, 8, 4, (2, 4)), (2, 2, 4, (0, 1)), (2, 4, 4, None), (6, 4, 4, None)])
def test_kv_span(q_off, q_len, g, want):
    assert kv_span(q_off, q_len, g) == want


def test_compress_decompress_is_the_reference_rounding():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(64,)).astype(np.float32)
    e = (rng.normal(size=(64,)) * 1e-3).astype(np.float32)
    q, ne = comp.compress_decompress(torch.from_numpy(g), torch.from_numpy(e))
    jq, jne = jcomp.compress_decompress(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
    zero = comp.init_error_state({"a": torch.ones(3, 2)})
    assert zero["a"].dtype == torch.float32 and not zero["a"].any()


def test_mesh_helpers_refuse_what_they_cannot_build():
    assert mesh_mod.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert mesh_mod.parse_mesh("8") == ((8,), ("data",))
    for bad in ("2x0", "2x2x2", "x"):
        with pytest.raises(ValueError):
            mesh_mod.parse_mesh(bad)
    with pytest.raises(AssertionError, match="256 ranks"):
        mesh_mod.make_production_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.init_group(0, 1, "cuda")
