"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) on 8
gloo ranks, a (2, 4) ("data", "model") mesh, held against the reference.

The setup is tests/test_moe_ep.py's: qwen3-moe-30b-a3b's smoke config (8
experts, top 2, 2 local experts a rank) and x [8, 16, D], here from a
numpy seed, one row of x a rank.  Each rank's loss is sum(out^2) + aux /
8, so the ranks' gradients add up to the gradient of sum(out^2) + the
aux loss's mean over the mesh (the reference's ``pmean``).

* bf16, capacity factor 8 (no drops): the forward and the gradients of
  wi/wg/wo/router against the reference's dense ``moe_apply`` and its
  ``jax.grad`` without a mesh, at the reference test's tolerances (the
  forward 2e-2 absolute, the gradients 5e-2 of the largest);
* float32, capacity factor 8: against the port's dense path run on each
  rank's row alone (so the aux terms are the same), at 1e-5;
* bf16, capacity factor 1 (drops): the forward against the reference's
  ``moe_apply_ep`` under an 8-device host mesh, in a subprocess;
* bf16, 32 experts, capacity factor 8: where the reference's EP drops
  real tokens behind padding (its fault), the port's against the
  reference's dense path;
* where ``ep_applicable`` is false, without any group.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_init as ref_moe_init
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import use_mesh
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.moe_ep import ep_applicable
from torch_mesh_ranks import SRC, spawn

ARCH = "qwen3-moe-30b-a3b"
# case -> (capacity factor, dtype, experts)
CASES = {"bf16_cf8": (8.0, "bfloat16", 8), "f32_cf8": (8.0, "float32", 8),
         "bf16_cf1": (1.0, "bfloat16", 8),
         "bf16_e32_cf8": (8.0, "bfloat16", 32)}

REF_EP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.models.moe import moe_apply
d = sys.argv[1]
z = np.load(os.path.join(d, "moe_in.npz"))
mesh = jax.make_mesh((2, 4), ("data", "model"))
w_spec = {"router": P(None, None), "wi": P("model", None, None),
          "wg": P("model", None, None), "wo": P("model", None, None)}
p_sh = {k: NamedSharding(mesh, v) for k, v in w_spec.items()}
x_sh = NamedSharding(mesh, P(("data", "model"), None, None))
for name, cf, e in (("bf16_cf1", 1.0, 8), ("bf16_e32_cf8", 8.0, 32)):
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              capacity_factor=cf, n_experts=e)
    p = {w: jnp.asarray(z[name + "/" + w], jnp.float32 if w == "router"
                        else jnp.bfloat16)
         for w in ("router", "wi", "wg", "wo")}
    x = jnp.asarray(z[name + "/x"], jnp.bfloat16)
    with jax.set_mesh(mesh):
        out, aux = jax.jit(lambda p_, x_: moe_apply(p_, x_, cfg),
                           in_shardings=(p_sh, x_sh))(p, x)
    np.save(os.path.join(d, name + "_ref_ep.npy"),
            np.asarray(out, np.float32))
"""


def _weights(cfg, seed):
    """The reference's ``moe_init`` weights (float32 numpy) and x."""
    p = ref_moe_init(jax.random.PRNGKey(seed), cfg)
    x = np.random.default_rng(seed).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}, x


def _port_moe(cfg, p):
    m = MoE(cfg, "cpu")
    with torch.no_grad():
        for w, v in p.items():
            getattr(m, w).copy_(torch.from_numpy(v))
    return m


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    """The 8 ranks over every case, and the reference's EP forward, run
    side by side."""
    d = str(tmp_path_factory.mktemp("moe_ep"))
    arrays = {"cases": json.dumps(CASES)}
    inputs = {}
    for i, (name, (cf, dtype, e)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(ref_smoke(ARCH), capacity_factor=cf,
                                  n_experts=e)
        p, x = _weights(cfg, i)
        if dtype == "bfloat16":     # what bf16 carries, exactly
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
            p = {k: v if k == "router" else np.asarray(
                jnp.asarray(v, jnp.bfloat16), np.float32)
                for k, v in p.items()}
        inputs[name] = (p, x)
        arrays.update({f"{name}/{k}": v for k, v in p.items()})
        arrays[f"{name}/x"] = x
    np.savez(os.path.join(d, "moe_in.npz"), **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_EP, d], env=env,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn("moe_ep", 8, d)
        _, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return types.SimpleNamespace(
        ranks=ranks, inputs=inputs,
        ref_ep={name: np.load(os.path.join(d, name + "_ref_ep.npy"))
                for name in ("bf16_cf1", "bf16_e32_cf8")})


def _gathered(ranks, name):
    """The ranks' outputs stacked back into x's rows, and each weight's
    gradient over the whole mesh: the router's partials summed, each
    expert bank's shards summed over "data" and stacked over "model"."""
    out = np.concatenate([r[f"{name}/out"] for r in ranks])
    grads = {"router": sum(r[f"{name}/grad_router"] for r in ranks)}
    for w in ("wi", "wg", "wo"):
        grads[w] = np.concatenate([
            sum(r[f"{name}/grad_{w}"] for r in ranks if r["coord"][1] == j)
            for j in range(4)])
    return out, grads


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def test_ep_matches_reference_dense_and_its_grads(ep_run):
    """bf16, no drops: 2e-2 absolute on the forward, 5e-2 of the largest
    gradient, the reference test's own tolerances (read on this input:
    1.56e-2, one bf16 step of the outputs near 2-4, and at most 9.0e-3,
    wo's)."""
    p, x = ep_run.inputs["bf16_cf8"]
    cfg = dataclasses.replace(ref_smoke(ARCH), capacity_factor=8.0)
    pj = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    xj = jnp.asarray(x, jnp.bfloat16)
    want, _ = ref_moe_apply(pj, xj, cfg)

    def loss(p_):
        o, aux = ref_moe_apply(p_, xj, cfg)
        return jnp.sum(o.astype(jnp.float32) ** 2) + aux

    g_ref = jax.grad(loss)(pj)
    out, grads = _gathered(ep_run.ranks, "bf16_cf8")
    assert np.max(np.abs(out - np.asarray(want, np.float32))) < 2e-2
    for w in ("wi", "wg", "wo", "router"):
        assert _rel(grads[w], np.asarray(g_ref[w], np.float32)) < 5e-2, w
    for r in ep_run.ranks:
        assert {"all-to-all", "all-reduce"} <= set(r["bf16_cf8/kinds"])


def test_ep_matches_port_dense_in_float32(ep_run):
    """float32, no drops: the port's dense ``moe_apply`` on each rank's
    row alone, loss sum(out^2) + aux / 8 summed over the rows, against
    the 8 ranks' EP, at 1e-5 of the largest value (read: the outputs
    equal, the gradients within 1.7e-7)."""
    p, x = ep_run.inputs["f32_cf8"]
    cfg = dataclasses.replace(get_smoke_config(ARCH), capacity_factor=8.0,
                              dtype=torch.float32)
    m = _port_moe(cfg, p)
    outs = []
    for row in torch.from_numpy(x).split(1):
        o, aux = moe_apply(m, row, cfg)
        (torch.sum(o ** 2) + aux / 8).backward()
        outs.append(o.detach().numpy())
    out, grads = _gathered(ep_run.ranks, "f32_cf8")
    assert _rel(out, np.concatenate(outs)) < 1e-5
    for w in ("wi", "wg", "wo", "router"):
        assert _rel(grads[w], getattr(m, w).grad.numpy()) < 1e-5, w


def test_ep_with_drops_matches_reference_ep(ep_run):
    """bf16 at capacity factor 1.0, so pairs are dropped at both stages'
    capacity: the forward against the reference's ``moe_apply_ep`` on an
    8-device host mesh, 2e-2 absolute (read: equal)."""
    out, _ = _gathered(ep_run.ranks, "bf16_cf1")
    assert np.max(np.abs(out - ep_run.ref_ep["bf16_cf1"])) < 2e-2


def test_ep_padding_takes_no_capacity(ep_run):
    """32 experts, 8 a rank, capacity factor 8: most of each rank's send
    slots are padding.  The reference's second stage buckets the padding
    it receives (local expert id 0) with expert 0's tokens, and from the
    second source rank on its padding fills expert 0's ``cap2`` and
    drops real tokens: its EP is off its own dense path by far more than
    bf16 rounding.  The port's padding takes no slot: its EP is within
    the first test's 2e-2 of the reference's dense ``moe_apply`` (read:
    the reference's EP off by 1.89, the port's by 1.56e-2)."""
    p, x = ep_run.inputs["bf16_e32_cf8"]
    cfg = dataclasses.replace(ref_smoke(ARCH), capacity_factor=8.0,
                              n_experts=32)
    pj = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    want = np.asarray(ref_moe_apply(pj, jnp.asarray(x, jnp.bfloat16),
                                    cfg)[0], np.float32)
    out, _ = _gathered(ep_run.ranks, "bf16_e32_cf8")
    assert np.max(np.abs(out - want)) < 2e-2
    assert np.max(np.abs(ep_run.ref_ep["bf16_e32_cf8"] - want)) > 0.1


def test_ep_not_applicable():
    """No mesh; a "model" axis of 1; experts that do not divide it; a
    mesh without "model"; a global batch that does not divide the mesh
    (none at all, or 4 rows on 8 chips); and on a mesh where the rest
    holds, no global batch is refused.  Shape-only stand-ins:
    ``ep_applicable`` reads names and sizes."""
    cfg = get_smoke_config(ARCH)           # 8 experts

    def mesh(**sizes):
        return types.SimpleNamespace(axis_names=tuple(sizes),
                                     axis_sizes=tuple(sizes.values()))
    assert not ep_applicable(cfg)
    for m, want in ((mesh(data=2, model=4), True),
                    (mesh(data=8, model=1), False),
                    (mesh(data=1, model=3), False),
                    (mesh(data=8), False)):
        with use_mesh(m, global_batch=8):
            assert ep_applicable(cfg) is want, m
    for n in (0, 4):
        with use_mesh(mesh(data=2, model=4), global_batch=n):
            assert not ep_applicable(cfg)
    with use_mesh(mesh(data=2, model=4)):
        with pytest.raises(ValueError, match="global batch"):
            ep_applicable(cfg)
