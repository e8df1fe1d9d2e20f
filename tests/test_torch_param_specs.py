"""The port's sharding specs (``repro_torch.models.model.make_param_specs``)
and the GSPMD backend's shard geometry against the JAX package's, on the
CPU.

Every config of the zoo at full shapes (the port's tree from the ``meta``
device, the reference's from ``jax.eval_shape``) on the layouts (16, 16)
("data", "model"), (2, 16, 16) ("pod", "data", "model"), (2, 2, 2) and
(4, 1), with FSDP and the expert-parallel rules each on and off, and
``Model.param_specs`` (the config's own flags): every leaf's spec equals
the reference's ``PartitionSpec`` entry for entry (trailing ``None``
kept, ``()`` for a replicated leaf), and so do its shard count, shard grid
and one shard's shape (``repro.launch.dist._shards_of``, ``_shard_grid``,
``_local_shape``).  The reference's own rule tests
(``tests/test_hints_and_specs.py::TestParamSpecRules``) are ported too.
Exact; no tolerance.

The decode caches' specs (``repro_torch.launch.dist.cache_specs``, ROADMAP
A12, part 4) too: every zoo config's caches at ``decode_32k`` and
``long_500k`` (where the config serves that shape), the port's on the
``meta`` device and the reference's from ``jax.eval_shape`` on
``repro.scale.costs.StubMesh``, on both production layouts; each device's
blocks divide the whole caches, and one device of (16, 16) holds 0.44 GB
of granite-20b's 112.1 GB cache at ``decode_32k``.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import INPUT_SHAPES
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_config as j_get_config
from repro.launch import dist as jdist
from repro.models.model import build_model as j_build_model
from repro.models.model import make_param_specs as j_make_param_specs
from repro.scale.costs import StubMesh
from repro_torch.configs.base import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten_with_path
from repro_torch.launch import dist as tdist
from repro_torch.launch.mesh import production_layout
from repro_torch.launch.shards import spec_block
from repro_torch.models.model import build_model, make_param_specs
from test_torch_decoder import port_cfg
from torch_dist_cases import _paths
from torch_serve_cases import spec_json

LAYOUTS = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
    "4x1": {"data": 4, "model": 1},
}
FLAGS = [(False, False), (True, False), (False, True), (True, True)]  # (fsdp, ep)


def fake_mesh(layout: dict):
    """A shape-only stand-in for a mesh of ``layout`` (the reference's spec
    rules read ``axis_names`` and ``devices.shape`` alone)."""
    return types.SimpleNamespace(axis_names=tuple(layout),
                                 devices=np.empty(tuple(layout.values()), dtype=object))


@functools.lru_cache(maxsize=None)
def trees(arch: str):
    """(reference abstract tree, port meta tree, reference model, port model)
    at full shapes."""
    jm = j_build_model(j_get_config(arch))
    tm = build_model(get_config(arch))
    with torch.device("meta"):
        tp = tm.init(torch.Generator())
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0)), tp, jm, tm


def jflat(specs):
    return ["/".join(k.key if hasattr(k, "key") else str(k) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, P))[0]], \
        jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))


def tflat(params, specs):
    flat, treedef = tree_flatten_with_path(params)
    return [path_str(p) for p, _ in flat], treedef.flatten_up_to(specs)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", PAPER_ARCHS + ASSIGNED_ARCHS)
def test_specs_and_shards_are_the_references(arch, layout):
    ja, tp, jm, tm = trees(arch)
    sizes = LAYOUTS[layout]
    mesh = fake_mesh(sizes)
    cases = [(f, e, j_make_param_specs(ja, mesh, fsdp=f, expert_parallel=e),
              make_param_specs(tp, sizes, fsdp=f, expert_parallel=e)) for f, e in FLAGS]
    cases.append(("own", "own", jm.param_specs(ja, mesh), tm.param_specs(tp, sizes)))
    jleaves = jax.tree.leaves(ja)
    sharded = 0
    for f, e, jspecs, tspecs in cases:
        jpaths, jl = jflat(jspecs)
        tpaths, tl = tflat(tp, tspecs)
        assert tpaths == jpaths
        for path, js, ts, leaf in zip(tpaths, jl, tl, jleaves):
            assert ts == tuple(js), (f, e, path, ts, js)
            assert tdist._shards_of(ts, sizes) == jdist._shards_of(js, sizes), path
            assert tdist._shard_grid(leaf.shape, ts, sizes) == jdist._shard_grid(
                leaf.shape, js, sizes), path
            assert tdist._local_shape(leaf.shape, ts, sizes) == jdist._local_shape(
                leaf.shape, js, sizes), path
            sharded += tdist._shards_of(ts, sizes) > 1
    assert sharded or arch in PAPER_ARCHS or layout == "4x1"


def test_device_blocks_cover_the_grid_in_the_references_device_order():
    """Each device of a client, row-major over the shard axes, holds the
    block its coordinates name: on (data 2, model 2) a leaf with spec
    ("model", "data") puts device (d, m) on block (m, d)."""
    sizes, shard_axes = {"data": 2, "model": 2}, ("data", "model")
    assert tdist._device_blocks((4, 6), ("model", "data"), sizes, shard_axes) == (0, 2, 1, 3)
    assert tdist._device_blocks((4, 6), ("data", "model"), sizes, shard_axes) == (0, 1, 2, 3)
    assert tdist._device_blocks((4, 6), (None, "model"), sizes, shard_axes) == (0, 1, 0, 1)
    assert tdist._device_blocks((4, 6), (), sizes, shard_axes) == (0, 0, 0, 0)
    assert tdist._device_blocks((8,), (("data", "model"),), sizes, shard_axes) == (0, 1, 2, 3)


# ---------------------------------------------------- the reference's rules


def _specs(jcfg, layout=LAYOUTS["16x16"], **kw):
    tcfg = port_cfg(jcfg)
    with torch.device("meta"):
        tp = build_model(tcfg).init(torch.Generator())
    paths, specs = tflat(tp, make_param_specs(tp, layout, **kw))
    return dict(zip(paths, specs))


def test_attention_tp_rules():
    got = _specs(JModelConfig(name="t", family="decoder", n_layers=2, d_model=1024,
                              n_heads=8, n_kv_heads=8, d_ff=4096, vocab_size=32000,
                              dtype=jnp.bfloat16))
    # a scanned stack's leading superblock dim stays unsharded
    assert [v for k, v in got.items() if k.endswith("inner/wq/w")][0] == (None, None, "model")
    assert [v for k, v in got.items() if k.endswith("inner/wo/w")][0] == (None, "model", None)
    assert got["embed/embedding"] == ("model", None)


def test_small_leaves_replicate():
    got = _specs(JModelConfig(name="t", family="decoder", n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=96,
                              dtype=jnp.float32))
    assert got and all(s == () for s in got.values()), got


def test_expert_parallel_rules():
    got = _specs(j_get_config("llama4-maverick-400b-a17b"), fsdp=True, expert_parallel=True)
    # (scan, E, d, ff): experts over data, ff over model, d unsharded
    assert [v for k, v in got.items() if k.endswith("moe/up")][0] == (None, "data", None, "model")
    assert [v for k, v in got.items() if k.endswith("moe/down")][0] == (None, "data", "model",
                                                                        None)


def test_mixtral_grouped_rules_keep_weights_data_free():
    got = _specs(j_get_config("mixtral-8x7b"), fsdp=True, expert_parallel=True)
    moe = {k: s for k, s in got.items()
           if "moe/" in k and k.split("/")[-1] in ("up", "gate", "down")}
    assert moe
    for key, s in moe.items():
        axes = [a for e in s for a in (e if isinstance(e, tuple) else (e,)) if a]
        assert "data" not in axes, (key, s)


def test_cnn_and_lstm_replicate_every_leaf():
    for arch in ("lenet5", "charlstm"):
        m = build_model(get_config(arch))
        with torch.device("meta"):
            tp = m.init(torch.Generator())
        _, specs = tflat(tp, m.param_specs(tp, LAYOUTS["16x16"]))
        assert all(s == () for s in specs)


def test_a_spec_on_a_client_axis_is_refused():
    """Data mode with FSDP would cut a leaf over "data", a client axis: with
    more than one client there the port's build_dist_train refuses it
    before any step (the reference's shard_map refuses an axis twice); a
    client axis of size 1 cuts nothing and runs, as the one-client
    variants of the chip phases do."""
    cfg = dataclasses.replace(get_config("granite_20b"), n_layers=1, client_mode="data")
    with pytest.raises(ValueError, match="client axes"):
        tdist.build_dist_train(cfg, device="cpu", mesh_shape={"data": 2, "model": 1},
                               sparsity=0.01)
    fns = tdist.build_dist_train(cfg, device="cpu", mesh_shape={"data": 1, "model": 2},
                                 sparsity=0.01)
    assert fns.channel.client_axes == ("data",) and fns.channel.n_clients == 1
    assert max(gl.n_shards for gl in fns.channel.leaves) == 2


# --------------------------------------------------- full size, shapes only

SERVE_SHAPES = ("decode_32k", "long_500k")
PRODUCTION = {"single": production_layout(), "multi": production_layout(multi_pod=True)}


def _ref_specs(arch: str, shape: str, layout: dict) -> dict:
    jm = trees(arch)[2]
    s = INPUT_SHAPES[shape]
    caches = jax.eval_shape(lambda: jm.init_caches(None, s["global_batch"], s["seq_len"]))
    specs = jdist.cache_specs(jm.cfg, StubMesh(tuple(layout.values()), tuple(layout)), caches)
    leaves = jax.tree.leaves(specs, is_leaf=lambda p: isinstance(p, P))
    return {p: (spec_json(sp), tuple(v.shape))
            for p, sp, v in zip(_paths(caches), leaves, jax.tree.leaves(caches))}


@pytest.mark.parametrize("layout", list(PRODUCTION))
@pytest.mark.parametrize("shape", SERVE_SHAPES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_at_full_size_are_the_references(arch, shape, layout):
    if j_get_config(arch).skip_reason(shape):
        assert get_config(arch).skip_reason(shape) == j_get_config(arch).skip_reason(shape)
        return
    sizes = PRODUCTION[layout]
    _, meta, _, tm = trees(arch)
    s = INPUT_SHAPES[shape]
    caches = tm.init_caches(meta, s["global_batch"], s["seq_len"])
    flat, treedef = tree_flatten_with_path(caches)
    specs = treedef.flatten_up_to(tdist.cache_specs(tm.cfg, sizes, caches))
    got = {path_str(p): (spec_json(sp), tuple(v.shape)) for (p, v), sp in zip(flat, specs)}
    assert got == _ref_specs(arch, shape, sizes)
    coords = {a: n - 1 for a, n in sizes.items()}  # the last device
    for (p, v), sp in zip(flat, specs):
        grid, _ = spec_block(tuple(v.shape), sp, sizes, coords)
        assert all(d % g == 0 for d, g in zip(v.shape, grid)), (path_str(p), sp)


def test_one_devices_blocks_of_granites_decode_32k_cache():
    """granite-20b at ``decode_32k`` (batch 128, 32,896 slots, one KV head)
    on (16, 16): the whole cache is 112.1 GB, one device holds 0.44 GB
    (the batch over "data", the sequence over "model"; ``pos`` whole)."""
    sizes = production_layout()
    _, meta, _, tm = trees("granite_20b")
    s = INPUT_SHAPES["decode_32k"]
    caches = tm.init_caches(meta, s["global_batch"], s["seq_len"])
    flat, treedef = tree_flatten_with_path(caches)
    specs = treedef.flatten_up_to(tdist.cache_specs(tm.cfg, sizes, caches))
    whole = mine = 0
    for (_, v), sp in zip(flat, specs):
        grid, _ = spec_block(tuple(v.shape), sp, sizes, {"data": 0, "model": 0})
        whole += v.numel() * v.element_size()
        mine += v.numel() // int(np.prod(grid)) * v.element_size()
    assert round(whole / 1e9, 1) == 112.1 and round(mine / 1e9, 2) == 0.44, (whole, mine)
