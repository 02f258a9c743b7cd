"""The reference's serving layouts on a mesh (``repro_torch.sharding.tp``)
held against its one-device run and the port's.

One spawn of 8 gloo ranks on a (2, 4) ("data", "model") mesh
(``torch_mesh_ranks.layouts``) runs the six families' smoke configs in
float32 (qwen3-4b, qwen3-moe-30b-a3b, falcon-mamba-7b, jamba-v0.1-52b,
whisper-base, qwen2-vl-72b; the MoE ones at capacity factor 8, so that
no path drops a token), with the reference's ``init`` weights carried
across by ``params_from_jax`` and placed by ``param_specs``: a prefill of
B = 2, S = 16 (the rows over "data"; the transformer families run their
4 positions a rank, the others FSDP) into a cache placed by
``cache_specs_tree``, then 3 tensor-parallel decode ticks
(``fsdp=False``) on the greedy tokens.  Each rank's logits, tokens and
cache shard against the same slice of the reference's jitted one-device
run and of the port's: within 1e-5 of the largest |value| (1e-4 for the
Mamba families, whose scan sums in another order), the greedy tokens
equal, the lengths exact.  The partial sums the mesh all-reduces (the
Dh-split logits, ``wo``, ``out``, ``x_proj``, the MoE combine) add in
another order than one device does, so the mesh is not bitwise.

The first tick's collectives move activations only: all-gathers and
all-reduces (and the Mamba state's all-to-alls), no all-gather as large
as the smallest sharded weight matrix.

Outside a mesh, ``fsdp=False`` and the sequence-split code change no bit
of any family's prefill and decode.
"""
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import get_model as ref_get_model
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import get_model
from repro_torch.models.weights import params_from_jax
from repro_torch.sharding import rules
from torch_mesh_ranks import spawn

ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "jamba-v0.1-52b", "whisper-base", "qwen2-vl-72b")
MAMBA = ("falcon-mamba-7b", "jamba-v0.1-52b")
B, S, MAX_LEN, TICKS, CF = 2, 16, 24, 3, 8.0
# a shape-only (2, 4) mesh for the specs
SIZES = types.SimpleNamespace(axis_names=("data", "model"),
                              axis_sizes=(2, 4))


def _tol(arch):
    return 1e-4 if arch in MAMBA else 1e-5


def _inputs(cfg, seed):
    """The prefill batch and each tick's vlm inputs, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        s = np.arange(S + TICKS)
        pos3 = np.stack([s, s // 4, s % 4 + s // 8], -1).astype(np.int32)
        pos3 = np.broadcast_to(pos3, (B, S + TICKS, 3))
        emb = rng.standard_normal((B, S + TICKS, cfg.d_model)).astype(
            np.float32)
        batch = {"embeds": emb[:, :S], "pos3": np.ascontiguousarray(
            pos3[:, :S])}
        ticks = [{"embeds": np.ascontiguousarray(emb[:, S + t:S + t + 1]),
                  "pos3": np.ascontiguousarray(pos3[:, S + t:S + t + 1])}
                 for t in range(TICKS)]
        return batch, ticks
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch, None


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)
            if not isinstance(tree, torch.Tensor) else tree.float().numpy()}


def _ref_cfg(arch):
    return dataclasses.replace(ref_smoke(arch), dtype=jnp.float32,
                               capacity_factor=CF)


def _weights(arch, seed):
    """The reference's ``init`` weights, numpy."""
    params = jax.jit(ref_get_model(_ref_cfg(arch)).init)(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _reference(arch, seed, weights):
    """The reference's jitted one-device prefill and greedy decode ticks
    on ``weights``: ([logits], [tokens], cache)."""
    rcfg = _ref_cfg(arch)
    api = ref_get_model(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    batch, ticks = _inputs(rcfg, seed)
    cache = api.init_cache(B, MAX_LEN)
    logits, cache = jax.jit(functools.partial(api.prefill,
                                              backend="chunked"))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cache)
    outs, toks = [np.asarray(logits)], []
    step = jax.jit(lambda p, t, c, e: api.decode_step(
        p, t, c, **({"batch_extra": e} if e else {})))
    for t in range(TICKS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        extra = None if ticks is None else {
            k: jnp.asarray(v) for k, v in ticks[t].items()}
        logits, cache = step(params, None if ticks else tok, cache, extra)
        outs.append(np.asarray(logits))
    return outs, toks, _flat(cache)


def _port(arch, weights, fsdp=True, ctx=None):
    """The port's one-device run on the same weights and inputs, its
    prefill under ``ctx``: ([logits], [tokens], cache)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              capacity_factor=CF, fsdp=fsdp)
    api = get_model(cfg)
    model = params_from_jax(weights, cfg, device="cpu")
    batch, ticks = _inputs(cfg, ARCHS.index(arch))
    cache = api.init_cache(B, MAX_LEN, device="cpu")
    with ctx or contextlib.nullcontext():
        logits, cache = api.prefill(
            model, {k: torch.from_numpy(v) for k, v in batch.items()},
            cache, backend="chunked")
    outs, toks = [logits.clone()], []
    for t in range(TICKS):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        if ticks:
            extra = {k: torch.from_numpy(v) for k, v in ticks[t].items()}
            logits, cache = api.decode_step(model, None, cache,
                                            batch_extra=extra)
        else:
            logits, cache = api.decode_step(model, tok, cache)
        outs.append(logits.clone())
    return ([o.numpy() for o in outs], [t.numpy() for t in toks],
            _flat(cache))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 8 ranks, and meanwhile the reference's and the port's
    one-device runs: (weights, ref, one, ranks)."""
    d = str(tmp_path_factory.mktemp("layouts"))
    arrays, weights = {}, {}
    for i, arch in enumerate(ARCHS):
        weights[arch] = _weights(arch, i)
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  dtype=torch.float32)
        ckpt.save(os.path.join(d, arch), 0,
                  params_from_jax(weights[arch], cfg, device="cpu"))
        batch, ticks = _inputs(cfg, i)
        arrays.update({f"{arch}/prefill/{k}": v for k, v in batch.items()})
        for t, extra in enumerate(ticks or ()):
            arrays.update({f"{arch}/tick{t}/{k}": v
                           for k, v in extra.items()})
    np.savez(os.path.join(d, "layouts_in.npz"), **arrays)
    with open(os.path.join(d, "layouts.json"), "w") as f:
        json.dump({"archs": ARCHS, "capacity_factor": CF,
                   "max_len": MAX_LEN, "ticks": TICKS, "seq": S}, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, "layouts", 8, d)
        ref = {a: _reference(a, i, weights[a]) for i, a in enumerate(ARCHS)}
        one = {a: _port(a, weights[a]) for a in ARCHS}
        return types.SimpleNamespace(weights=weights, ref=ref, one=one,
                                     ranks=ranks.result())


def _close(got, want, tol, label):
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), (label, err)


def _stand_in(coord):
    """A (2, 4) mesh at ``coord`` for ``local_slices``."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4), get_coordinate=lambda: coord)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_tokens_on_every_rank(run, arch):
    """Each rank's rows of the prefill's and every tick's logits against
    the reference's and the port's one-device run; its greedy tokens
    equal to the reference's."""
    ref_logits, ref_tokens, _ = run.ref[arch]
    one_logits = run.one[arch][0]
    for r in run.ranks:
        rows = slice(int(r["coord"][0]), int(r["coord"][0]) + 1)
        for t in range(TICKS + 1):
            got = r[f"{arch}/logits{t}"]
            _close(got, ref_logits[t][rows], _tol(arch), (arch, t, "ref"))
            _close(got, one_logits[t][rows], _tol(arch), (arch, t, "port"))
        for t in range(TICKS):
            assert np.array_equal(r[f"{arch}/tokens{t}"],
                                  ref_tokens[t][rows]), (arch, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_transformer_families_split_the_sequence(run, arch):
    """The prefill gathered K/V along the sequence, [1, S/4] a rank into
    [1, S], twice a layer in the dense, moe and vlm families (their batch
    of 2 leaves "model" idle), and never in the others (FSDP)."""
    cfg = get_smoke_config(arch)
    for r in run.ranks:
        got = r[f"{arch}/seq_gathers"].tolist()
        if cfg.family in ("dense", "moe", "vlm"):
            assert got == [[1, S // 4, cfg.n_kv, cfg.d_head]] * (
                2 * cfg.n_layers), arch
        else:
            assert got == [], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shard_on_every_rank(run, arch):
    """After the ticks, each rank's cache leaves equal its
    ``cache_specs_tree`` slice of the reference's cache: K/V with Dh over
    "model", the Mamba state with N (its conv state with Di), the
    lengths exact and whole."""
    ref_cache = run.ref[arch][2]
    specs = rules.cache_specs_tree(
        {k: torch.empty(v.shape) for k, v in ref_cache.items()}, SIZES)
    for r in run.ranks:
        mesh = _stand_in(tuple(int(c) for c in r["coord"]))
        for key, want in ref_cache.items():
            want = want[rules.local_slices(want.shape, specs[key], mesh)]
            got = r[f"{arch}/cache/{key}"]
            assert got.shape == want.shape, (arch, key, got.shape)
            if key.endswith("len"):
                assert np.array_equal(got, want), (arch, key)
                assert got.tolist() == [S + TICKS] * B
            else:
                _close(got, want, _tol(arch), (arch, key))
    assert specs["k" if arch != "falcon-mamba-7b" else "h"][-1] == "model"


@pytest.mark.parametrize("arch", ARCHS)
def test_a_tick_gathers_no_weight(run, arch):
    """The first tensor-parallel tick's collectives: all-reduces and
    all-gathers (the Mamba families also their state's all-to-alls), and
    no all-gather output as large as the smallest weight matrix
    ``param_specs`` shards: only activations move."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    model = get_model(cfg).init(0, device="cpu")
    from repro_torch.models.weights import leaf_map
    leaves = leaf_map(model, cfg)
    sharded = [4 * int(np.prod(leaf.params[0].shape))
               for key, spec in rules.param_specs(model, SIZES).items()
               for leaf in (leaves[key],)
               if any(e is not None for e in spec)
               and leaf.params[0].ndim >= 2]
    want_kinds = {"all-gather", "all-reduce"} | (
        {"all-to-all"} if arch in MAMBA else set())
    for r in run.ranks:
        kinds = {k.split("/")[-1] for k in r if k.startswith(f"{arch}/wire/")}
        assert kinds == want_kinds, (arch, kinds)
        assert max(r[f"{arch}/wire/all-gather"]) < min(sharded), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_outside_a_mesh_the_layouts_change_no_bit(run, arch):
    """``fsdp=False`` with no mesh, and a prefill under
    ``use_mesh(None, global_batch=B)``, give the port's one-device run bit
    for bit."""
    got = _port(arch, run.weights[arch], fsdp=False,
                ctx=use_mesh(None, global_batch=B))
    want = run.one[arch]
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w), arch
    for g, w in zip(got[1], want[1]):
        assert np.array_equal(g, w), arch
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert np.array_equal(got[2][k], want[2][k]), (arch, k)
