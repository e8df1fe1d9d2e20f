"""Pod mode and the "model" axis through ``build_run`` and the Eq. 1 pins
of ``chip_smoke.py``'s pod phase, against the JAX package, on the CPU.

The reference's Eq. 1 bits of a layout come from its own
``ShardedGspmdChannel.bits()`` over the ``GspmdLeaf`` plan that its
``build_dist_train`` derives (``make_param_specs``, ``_shards_of``,
``_shard_grid``, and ``_sharded_flat_space`` where the flat path runs),
built here on a shape-only mesh: its ``build_dist_train`` wants real
devices for the layout's shardings, and only shapes decide the bits.

  * the pod-mode decoders (granite-20b, command-r-35b, mixtral) run on the
    GSPMD backend at reduced size through ``build_run(..., mesh_shape=)``
    on the default layout and on layouts of several shards, with the
    reference's bits;
  * the pins of ``chip_smoke.py``'s pod phase (``POD_PINS``: granite-20b's
    2 layers at full width on (16, 16) in its f32 variant, the widened
    reduced granite on (2, 2, 2), mixtral's 1 layer at its own dtypes on
    (16, 16)) equal the reference's bits, parameters, rows and padded
    length.

Exact; no tolerance.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.channel import GspmdLeaf, ShardedGspmdChannel
from repro.launch import dist as jdist
from repro.models.model import build_model as j_build_model
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.tree import tree_flatten
from repro_torch.data import make_lm_task
from repro_torch.launch.dist import build_dist_train
from repro_torch.run import RunSpec, build_run
from torch_dist_cases import WIDE
from torch_helpers import load_chip_smoke, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def reference_bits(jcfg, layout: dict, sparsity: float, fast: bool) -> dict:
    """The reference's Eq. 1 bits a client a round of ``jcfg`` on
    ``layout``, its parameters, its SBC rows (L x shards, summed) and, on
    the flat path, one device's padded length."""
    mesh = types.SimpleNamespace(axis_names=tuple(layout),
                                 devices=np.empty(tuple(layout.values()), dtype=object))
    a = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    specs = j_build_model(jcfg).param_specs(a, mesh)
    flat_p = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    paths = ["/".join(k.key for k in p) for p, _ in flat_p]
    scanned = ["stack/scan" in p for p in paths]
    n_clients, client_axes = jdist.client_topology(jcfg, mesh)
    leaves = tuple(
        GspmdLeaf(path=p, global_shape=tuple(v.shape), dtype=v.dtype, scanned=sc,
                  mode="sparse", rate=sparsity, n_shards=jdist._shards_of(s, layout),
                  shard_grid=jdist._shard_grid(v.shape, s, layout))
        for p, (_, v), sc, s in zip(paths, flat_p, scanned, flat_specs))
    space = None
    if fast:
        space = jdist._sharded_flat_space(jcfg, mesh, flat_p, flat_specs, scanned,
                                          ["sparse"] * len(leaves), [sparsity] * len(leaves),
                                          client_axes, n_clients)
    ch = ShardedGspmdChannel(leaves=leaves, client_axes=client_axes, n_clients=n_clients,
                             residual_dtype=jcfg.residual_dtype, flat_space=space)
    rows = sum((gl.global_shape[0] if gl.scanned and len(gl.global_shape) > 1 else 1)
               * gl.n_shards for gl in leaves)
    return dict(eq1=ch.bits().per_client, params=sum(math.prod(v.shape) for _, v in flat_p),
                leaves=len(leaves), rows=rows, n_pad=space.n_pad if space else None,
                shards=space.shards_per_client if space else None)


@pytest.mark.parametrize("layout", [None, {"data": 2, "model": 2},
                                    {"pod": 2, "data": 2, "model": 2}])
@pytest.mark.parametrize("preset", ["granite_20b", "command_r_35b", "mixtral_8x7b"])
def test_pod_mode_presets_run_on_gspmd(preset, layout):
    """One client a pod (at world 1 the "pod" axis must be 1 or absent),
    the per-leaf exchange of the presets' bf16 residual: finite losses,
    Eq. 1 bits the reference's on the layout."""
    if layout and "pod" in layout:
        with pytest.raises(ValueError, match="one client a rank"):
            build_run(RunSpec(preset=preset, backend="gspmd"), device="cpu", mesh_shape=layout)
        return
    spec = dict(preset=preset, backend="gspmd", rounds=2, batch=2, seq_len=8, sparsity=0.05)
    run = build_run(RunSpec(**spec), device="cpu", mesh_shape=layout)
    _, hist = run.run()
    assert np.isfinite(hist["loss"]).all() and run.n_clients == 1
    jcfg = j_reduced(j_get_config(preset))
    want = reference_bits(jcfg, layout or {"data": 1, "model": 1}, 0.05, fast=False)
    assert run.fns.bits_per_client == want["eq1"]


def test_f32_pod_variant_runs_every_engine_per_shard():
    """The widened reduced granite (``torch_dist_cases.WIDE``, f32, FSDP) on
    (data 2, model 2), one client of 4 shards: the per-leaf, exact (device
    pack, metered) and hist engines; per leaf and exact give the same
    params bit for bit, every engine the reference's bits."""
    cfg = reduced(get_config("granite_20b"), **WIDE, fsdp=True, residual_dtype=torch.float32)
    jcfg = j_reduced(j_get_config("granite_20b"), **WIDE, fsdp=True,
                     residual_dtype=jnp.float32)
    task = make_lm_task(vocab=cfg.vocab_size, batch=2, seq_len=8, seed=0, device="cpu")
    layout = {"data": 2, "model": 2}
    params = {}
    for name, kw in (("leaf", dict(fast=False)),
                     ("exact", dict(fast=True, flat_engine="exact", device_pack=True,
                                    measure=True)),
                     ("hist", dict(fast=True, flat_engine="hist"))):
        fns = build_dist_train(cfg, device="cpu", sparsity=0.01, mesh_shape=layout, **kw)
        want = reference_bits(jcfg, layout, 0.01, fast=kw["fast"])
        assert fns.bits_per_client == want["eq1"], name
        assert max(gl.n_shards for gl in fns.channel.leaves) == 4
        state = fns.init_state(torch.Generator().manual_seed(0))
        for r in range(2):
            state, m = fns.train_step(state, {k: v[None] for k, v in task.sample(r, 0).items()})
            assert np.isfinite(float(m["loss"]))
            if name == "exact":
                assert tuple(m["packed_nbits"].shape) == (1, 4, fns.flat_space.n_mu)
                assert fns.channel.record_round(r, packed_nbits=m["packed_nbits"]) > 0
        params[name] = state["params"]
        if fns.flat_space is not None:
            assert tuple(state["residual"].shape) == (1, 4, want["n_pad"])
    for a, b in zip(tree_flatten(params["leaf"])[0], tree_flatten(params["exact"])[0]):
        assert torch.equal(a, b)


def _pin_cfg(pin: dict):
    """The reference's config of a ``POD_PINS`` entry."""
    base = j_get_config(pin["preset"])
    if pin.get("reduced"):
        base = j_reduced(base)
    kw = {k: (DT[v] if k.endswith("dtype") else v) for k, v in pin["changes"].items()}
    return dataclasses.replace(base, **kw)


@pytest.mark.parametrize("phase", ["a", "b", "c"])
def test_chip_smoke_pod_pins_are_the_references(phase):
    pin = load_chip_smoke().POD_PINS[phase]
    want = reference_bits(_pin_cfg(pin), pin["layout"], pin["sparsity"], pin["fast"])
    for key in ("eq1", "params", "leaves", "rows", "n_pad", "shards"):
        assert pin[key] == want[key], (phase, key, pin[key], want[key])
