"""The port's sharding rules (``repro_torch.sharding``) and collective
accounting (``repro_torch.roofline.collectives``) against the reference's
``sharding/rules.py`` and ``roofline/hlo.py``; no process group needed.

* For all 10 architectures at their published configs, on the 16 x 16
  and 2 x 16 x 16 production meshes (shape-only stand-ins, as in
  tests/test_roofline_sharding.py): ``param_specs`` and
  ``opt_state_specs`` leaf by leaf over ``jax.eval_shape(init)`` against
  the port's model on fake tensors, ``batch_specs`` over the input specs
  of every applicable shape, and ``cache_specs_tree`` over every prefill
  and decode cache, all exactly.
* The four spec cases of tests/test_roofline_sharding.py.
* ``collective_stats`` over the five collectives of
  ``test_collective_parser_bytes`` as records (rel 1e-6), and a recorded
  run with no collective.
* Outside a mesh every hint returns its argument.
"""
import types

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.models import get_model as ref_get_model
from repro.models import registry as ref_registry
from repro.roofline.hlo import collective_stats as ref_collective_stats
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applies
from repro_torch.models import registry
from repro_torch.roofline.collectives import (CollectiveRecord,
                                              collective_stats,
                                              record_collectives)
from repro_torch.sharding import rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, axes):
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _flat(tree):
    """{"a/b/c": spec as a tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_flat(tree, prefix=""):
    """The same of a port spec tree (nested dicts and tuples of ``P``)."""
    if isinstance(tree, rules.P):
        return {prefix[:-1]: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}{k}/"))
    return out


def _shapes(arch):
    return [s for s in SHAPES if shape_applies(get_config(arch), s)[0]]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_on_production_meshes(arch, mesh_name):
    mesh = _mesh(*MESHES[mesh_name])
    rcfg = ref_configs.get_config(arch)
    rapi = ref_get_model(rcfg)
    sds = jax.eval_shape(rapi.init, jax.random.PRNGKey(0))
    cfg = get_config(arch)
    with FakeTensorMode():
        model = registry.param_specs(cfg)
        assert rules.param_specs(model, mesh) == \
            _flat(ref_rules.param_specs(sds, mesh))
        assert rules.opt_state_specs(model, mesh) == \
            _flat(ref_rules.opt_state_specs(sds, mesh))
        for name in _shapes(arch):
            sh = SHAPES[name]
            b, s = sh.global_batch, sh.seq_len
            if sh.kind == "train":
                want = ref_registry.train_input_specs(rcfg, b, s)
                got = registry.train_input_specs(cfg, b, s)
            elif sh.kind == "prefill":
                want = ref_registry.prefill_input_specs(rcfg, b, s)
                got = registry.prefill_input_specs(cfg, b, s)
            else:
                want = ref_registry.decode_input_specs(rcfg, b)
                got = registry.decode_input_specs(cfg, b)
            assert _port_flat(rules.batch_specs(got, mesh)) == \
                _flat(ref_rules.batch_specs(want, mesh, fsdp=True)), name
            if sh.kind != "train":
                rc = jax.eval_shape(lambda: rapi.init_cache(b, s))
                pc = registry.cache_specs(cfg, b, s)
                assert _port_flat(rules.cache_specs_tree(pc, mesh)) == \
                    _flat(ref_rules.cache_specs_tree(rc, mesh)), name


def _t(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def test_param_specs_rules():
    specs = rules.param_specs({"embed/tok": _t(1024, 64),
                               "layers/attn/wq": _t(4, 64, 128),
                               "layers/moe/wi": _t(4, 16, 64, 32),
                               "layers/ln1/scale": _t(64)})
    assert specs["embed/tok"] == rules.P("model", None)
    assert specs["layers/attn/wq"] == rules.P(None, None, "model")
    assert specs["layers/moe/wi"] == rules.P(None, "model", None, None)
    assert specs["layers/ln1/scale"] == rules.P(None)


def test_param_specs_divisibility_fallback():
    mesh = _mesh((2, 16), ("data", "model"))
    specs = rules.param_specs({"embed/tok": _t(51865, 512)}, mesh)
    assert specs["embed/tok"] == rules.P(None, None)  # 51865 % 16 != 0


def test_batch_specs_cascade():
    mesh = _mesh((2, 4, 8), ("pod", "data", "model"))
    specs = rules.batch_specs({"tokens": _t(64, 128), "one": _t(1, 128),
                               "mid": _t(8, 128)}, mesh)
    assert specs["tokens"] == rules.P(("pod", "data", "model"), None)
    assert specs["one"] == rules.P(None, None)
    assert specs["mid"] == rules.P(("pod", "data"), None)


def test_cache_specs():
    mesh = _mesh((16, 16), ("data", "model"))
    specs = rules.cache_specs_tree({"k": _t(36, 128, 32768, 8, 128),
                                    "len": _t(128)}, mesh)
    assert specs["k"] == rules.P(None, "data", None, None, "model")
    assert specs["len"] == rules.P()


# test_collective_parser_bytes's five collectives: (kind, output shape,
# bytes an element, group)
COLLECTIVES = [("all-gather", (128, 4096), 4, 16),
               ("all-reduce", (512, 512), 2, 4),
               ("reduce-scatter", (32, 256), 4, 8),
               ("collective-permute", (64, 64), 4, 2),
               ("all-to-all", (16, 1024), 2, 4)]
HLO = """
HloModule test
ENTRY main {
  %p = f32[128,256]{1,0} parameter(0)
  %ag = f32[128,4096]{1,0} all-gather(%p), replica_groups=[16,16]<=[256], dimensions={1}
  %ar = bf16[512,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[32,256]{1,0} reduce-scatter(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %cp = f32[64,64]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %aa = bf16[16,1024]{1,0} all-to-all(%w), replica_groups=[4,4]<=[16]
}
"""


def test_collective_stats_equal_reference_wire_bytes():
    """The permute's group is the reference's default (``num_partitions``,
    unused by its formula): ``None`` here."""
    recs = [CollectiveRecord(kind, int(np.prod(shape)) * el,
                             None if kind == "collective-permute" else n)
            for kind, shape, el, n in COLLECTIVES]
    got = collective_stats(recs, num_partitions=256)
    want = ref_collective_stats(HLO, num_partitions=256)
    assert got.counts == want.counts
    assert got.bytes_moved == want.bytes_moved
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-6)
    assert [o["wire_bytes"] for o in got.ops] == pytest.approx(
        [o["wire_bytes"] for o in want.ops], rel=1e-6)
    # as dicts too
    assert collective_stats([r.__dict__ for r in recs],
                            num_partitions=256).wire_bytes == got.wire_bytes


def test_non_collectives_add_nothing():
    with record_collectives() as recs:
        a = torch.ones(8, 8)
        (a @ a).sum()
    st = collective_stats(recs, num_partitions=8)
    assert recs == [] and st.total_count == 0 and st.wire_bytes == 0


def test_hints_are_the_identity_outside_a_mesh():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    x = torch.randn(2, 3, 4)
    assert rules.replicate_hint(x) is x
    model = get_model(get_smoke_config("qwen3-4b")).init(0, device="cpu")
    attn = model.layers[0].attn
    assert rules.fsdp_params(attn) is attn
    assert rules.fsdp_params(attn.wq) is attn.wq


def test_make_mesh_needs_a_group_of_its_size():
    """No default group in this process: ``make_mesh`` says so; the ambient
    mesh is ``None`` outside ``use_mesh``."""
    from repro_torch.launch.mesh import (current_mesh, make_mesh,
                                         make_production_mesh, mesh_chips,
                                         use_mesh)
    with pytest.raises(RuntimeError, match="no default process group"):
        make_mesh((2, 4), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="no default process group"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    m = _mesh(*MESHES["2x16x16"])
    assert mesh_chips(m) == 512 and current_mesh() is None
    with use_mesh(m):
        assert current_mesh() is m
    assert current_mesh() is None
