"""The MoE and recurrent decoders (mixtral-8x7b, llama4-maverick,
jamba-v0.1, rwkv6-1.6b; ROADMAP A12, part 3, items 1 and 2) on the
port's backends, against the JAX package, on the CPU: one local DSGD
round of each, the other backends, ``chip_smoke.py``'s mixtral pin and
the flat buffer's index-width guard.  Their models (trees, gradients,
decode, the MoE policy) are ``tests/test_torch_zoo_model.py``, their
greedy serving ``tests/test_torch_zoo_serve.py`` (with jamba's round);
jamba's and llama4's presets on the fed backend also run in
``tests/test_torch_decoder_run.py::test_the_rest_of_the_zoo_still_raises``.

Tolerances:
  * one local round (sbc, 2 clients, p = 0.02, the wire metered, the
    config's optimizer; rwkv6's Adam warm, as
    ``tests/test_torch_local_run.py`` starts it) from the reference's
    parameters and the same batch: the loss to ``rtol=1e-5``; Eq. 1 bits
    and the measured bits equal; the survivors (ΔW*'s support) equal but
    for at most 2 entries of a leaf, and the parameters within 1e-5
    (relative) where the survivors agree.  The frameworks' f32 gradients
    differ in their last bits, which can swap two entries that a client's
    k-th magnitude separates by less: llama4's ``moe/up`` (top-1) swaps 2
    of its 524,288 entries (measured), the other three archs none;
  * the GSPMD hist engine (rwkv6): a finite round and the reference's Eq. 1
    bits; the pod configs' refusal (ROADMAP A12, part 3, item 6); rwkv6 on
    the fed backend: a finite round and a reconciled ledger;
  * ``MIXTRAL1_EQ1``: the reference's Eq. 1 bits for mixtral at full
    width, one layer, p = 0.001, from shapes alone, never drawing its
    1,582,346,240 parameters: equal;
  * the guard: ``ValueError`` from shapes on the ``meta`` device.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from jax.sharding import Mesh
from repro.configs import base as jbase
from repro.core import channel as jchannel
from repro.launch.dist import build_dist_train as j_build_dist_train
from repro.models.model import build_model as j_build_model
from repro.optim.optimizers import AdamState as JAdamState
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro.train.trainer import TrainState as JTrainState
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import channel as tchannel
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
from repro_torch.launch.mesh import make_host_group
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import AdamState
from repro_torch.run import RunSpec, build_run
from repro_torch.train import TrainState
from test_torch_decoder import port_cfg
from test_torch_decoder_run import leaf_dict
from torch_helpers import load_chip_smoke, n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SEQ, BATCH = 32, 2


def jax_state(jrun):
    """The reference's initial local state (``DSGDTrainer.init``'s key
    split and parts), its Adam state warm."""
    trainer = jrun.trainer
    p_rng, c_rng = jax.random.split(jax.random.PRNGKey(jrun.spec.seed))
    params = trainer.model.init(p_rng)
    opt = trainer.optimizer.init(params)
    if isinstance(opt, JAdamState):
        rng = np.random.default_rng(42)
        opt = JAdamState(*(jax.tree.map(
            lambda x: jnp.asarray(f(rng.standard_normal((2,) + x.shape)), jnp.float32), s)
            for f, s in ((lambda v: 0.01 * v, opt.m), (lambda v: (0.01 * v) ** 2, opt.v))))
    return JTrainState(params, opt, trainer.channel.init_state(params, c_rng),
                       jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("name", ["mixtral_8x7b", "llama4_maverick_400b_a17b", "rwkv6_1p6b"])
def test_one_local_dsgd_round_matches(name):
    """jamba's round is ``tests/test_torch_zoo_serve.py``'s, which keeps
    each file within a minute (the reference compiles it for 22 s)."""
    one_round(name)


def one_round(name: str, extra: dict | None = None, mu_rtol: float = 0.0) -> None:
    """One local round of ``name``'s preset in both packages, from the
    reference's parameters and the same batch (with the numpy fields of
    ``extra``, as ``(clients, 1, batch, ...)`` arrays), held as the module
    says; ``mu_rtol`` adds an absolute tolerance of that share of the
    leaf's largest |ΔW*| (the noise μ carries from the gradients)."""
    spec = dict(preset=name, backend="local", clients=2, sparsity=0.02, rounds=1,
                measure_wire=True, batch=BATCH, seq_len=SEQ)
    jrun, trun = j_build_run(JRunSpec(**spec)), build_run(RunSpec(**spec), device="cpu")
    jstate = jax_state(jrun)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
    opt = (AdamState(*(params_from_jax(jax.tree.map(np.asarray, s), "cpu")
                       for s in jstate.opt_states))
           if isinstance(jstate.opt_states, JAdamState) else ())
    tstate = TrainState(params, opt, trun.trainer.channel.init_state(params),
                        torch.zeros((), dtype=torch.int32))
    toks = np.random.default_rng(2).integers(0, trun.cfg.vocab_size, (2, 1, BATCH, SEQ + 1))
    data = {"tokens": toks[..., :-1].astype(np.int32), "labels": toks[..., 1:].astype(np.int32),
            **(extra or {})}
    jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data)
    trun.batch_fn = lambda r: {k: t(v) if v.dtype.kind == "f" else t(v).long()
                               for k, v in data.items()}
    jstate2, jm = jrun.step(jstate, 0)
    tstate2, tm = trun.step(tstate, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(tm["bits_per_client"]) == float(jm["bits_per_client"])
    assert tm["measured_bits_per_client"] == jm["measured_bits_per_client"]
    want, before = leaf_dict(jstate2.params), leaf_dict(jstate.params)
    for p, v in tree_flatten_with_path(tstate2.params)[0]:
        k = path_str(p)
        moved_t, moved_j = n(v) != before[k], want[k] != before[k]
        assert moved_j.any() and int((moved_t != moved_j).sum()) <= 2, f"{name} {k}: survivors"
        agree = moved_t == moved_j
        atol = max(1e-8, mu_rtol * float(np.abs(want[k] - before[k]).max()))
        np.testing.assert_allclose(n(v)[agree], want[k][agree], rtol=1e-5, atol=atol,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("preset", ["rwkv6_1p6b", "mixtral_8x7b", "llama4_maverick_400b_a17b",
                                    "jamba_v01_52b"])
def test_gspmd_hist_runs_rwkv6_and_refuses_the_pod_configs(preset):
    """rwkv6 (``client_mode="data"``) runs a round on the GSPMD hist engine
    with the reference's Eq. 1 bits.  The three MoE configs are pod mode,
    which runs on gspmd now (ROADMAP A12, part 3, item 6): their bf16
    residual keeps them off the flat engines, so the hist engine raises the
    reference's ``ValueError``, and a round of the per-leaf exchange runs
    with the reference's bits."""
    spec = RunSpec(preset=preset, backend="gspmd", fast=True, flat_engine="hist", rounds=1,
                   clients=1, sparsity=0.05, batch=BATCH, seq_len=16)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jcfg = jbase.reduced(jbase.get_config(preset))
    if preset != "rwkv6_1p6b":
        for build in (lambda: build_run(spec, device="cpu"),
                      lambda: j_build_dist_train(jcfg, mesh, compressor="sbc", sparsity=0.05,
                                                 fast=True, flat_engine="hist")):
            with pytest.raises(ValueError, match="flat_engine='hist' needs"):
                build()
        spec = dataclasses.replace(spec, fast=False, flat_engine="exact")
    run = build_run(spec, device="cpu")
    _, hist = run.run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    jfns = j_build_dist_train(jcfg, mesh, compressor="sbc", sparsity=0.05, fast=spec.fast or None,
                              flat_engine=spec.flat_engine)
    assert run.fns.bits_per_client == jfns.bits_per_client


def _gspmd_bits(pkg, cfg, p):
    """Eq. 1 bits a client of the GSPMD backend on one client, from the
    tree's shapes (every leaf SBC at ``p``): the channel's per-leaf sum,
    which its flat space reproduces (the same totals)."""
    if pkg == "jax":
        shapes = jax.eval_shape(j_build_model(cfg).init, jax.random.PRNGKey(0))
        flat = [("/".join(k.key for k in path), v)
                for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]]
        leaves = tuple(jchannel.GspmdLeaf(path=k, global_shape=tuple(v.shape), dtype=v.dtype,
                                          scanned="stack/scan" in k, mode="sparse", rate=p,
                                          n_shards=1, shard_grid=(1,) * len(v.shape))
                       for k, v in flat)
        return jchannel.ShardedGspmdChannel(leaves=leaves, client_axes=("data",),
                                            n_clients=1).bits().per_client
    with torch.device("meta"):
        shapes = build_model(cfg).init(torch.Generator())
    leaves = tuple(tchannel.GspmdLeaf(path=path_str(k), global_shape=tuple(v.shape),
                                      dtype=v.dtype, scanned="stack/scan" in path_str(k),
                                      mode="sparse", rate=p, n_shards=1,
                                      shard_grid=(1,) * v.dim())
                   for k, v in tree_flatten_with_path(shapes)[0])
    return tchannel.ShardedGspmdChannel(leaves=leaves, client_axes=("data",), n_clients=1,
                                        group=make_host_group("cpu")).bits().per_client


def test_chip_smoke_mixtral_pin_is_the_references():
    """``chip_smoke.py`` phase 13a's mixtral (full width, one layer, f32,
    client mode "data"): its parameter count, its leaves, its largest
    segment and its Eq. 1 bits a client (``MIXTRAL1_EQ1``) from the
    reference's shapes and the port's; and phase 13b's parameter counts."""
    smoke = load_chip_smoke()
    variant = smoke.MIXTRAL1_VARIANT
    jcfg = dataclasses.replace(jbase.get_config("mixtral_8x7b"), n_layers=1,
                               dtype=jnp.float32, residual_dtype=jnp.float32,
                               client_mode=variant["client_mode"])
    tcfg = dataclasses.replace(tbase.get_config("mixtral_8x7b"), n_layers=1, **{
        k: getattr(torch, v) if k.endswith("dtype") else v for k, v in variant.items()})
    assert port_cfg(jcfg) == tcfg
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    sizes = [int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)]
    assert (sum(sizes), len(sizes), max(sizes)) == (
        smoke.MIXTRAL1_PARAMS, smoke.MIXTRAL1_LEAVES, smoke.MIXTRAL1_SEGMENT)
    p = smoke.MIXTRAL1["sparsity"]
    assert _gspmd_bits("jax", jcfg, p) == _gspmd_bits("torch", tcfg, p) == smoke.MIXTRAL1_EQ1
    for name, layers, _, _, count in smoke.SERVE_ZOO:
        cfg = dataclasses.replace(jbase.get_config(name), n_layers=layers)
        shapes = jax.eval_shape(j_build_model(cfg).init, jax.random.PRNGKey(0))
        assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)) == count, name


def test_chip_smoke_accumulate_row_is_the_mixtral_cells_width():
    """``chip_smoke.py``'s ``seg_accumulate`` row runs at the mixtral
    benchmark cell's layout: the cell's configuration file sets the
    variant's keys as ``MIXTRAL1_CELL_VARIANT`` does (the untied head
    among them) at one layer, and the port's model of that variant has
    ``MIXTRAL1_CELL_LEAVES`` leaves and ``MIXTRAL1_CELL_PARAMS`` entries,
    from shapes alone."""
    smoke = load_chip_smoke()
    variant = smoke.MIXTRAL1_CELL_VARIANT
    path = pathlib.Path(__file__).resolve().parent.parent / "perfbench" / "configs"
    cell = json.loads((path / "mixtral-8x7b-l1.json").read_text())["model"]
    assert cell["n_layers"] == 1 and {k: cell[k] for k in variant} == variant
    assert variant["tie_embeddings"] is False
    cfg = dataclasses.replace(tbase.get_config("mixtral_8x7b"), n_layers=1, **{
        k: getattr(torch, v) if k.endswith("dtype") else v for k, v in variant.items()})
    with torch.device("meta"):
        leaves = tree_flatten(build_model(cfg).init(torch.Generator()))[0]
    assert (sum(v.numel() for v in leaves), len(leaves)) == (
        smoke.MIXTRAL1_CELL_PARAMS, smoke.MIXTRAL1_CELL_LEAVES)


def test_flat_buffers_past_the_kernels_offsets_raise():
    """Mixtral at two layers is 3.0 G entries: past the 2^31 − 1 that the
    kernels' 32-bit offsets index.  The flat kernels and the flat spaces
    raise ``ValueError`` from shapes alone (``meta`` tensors); one layer
    (1.58 G) is inside."""
    from repro_torch.core.flat import ShardedFlatParamSpace
    from repro_torch.kernels import flat as kflat

    cfg = dataclasses.replace(tbase.get_config("mixtral_8x7b"), dtype=torch.float32)
    sizes = {}
    for layers in (1, 2):
        with torch.device("meta"):
            shapes = build_model(dataclasses.replace(cfg, n_layers=layers)).init(
                torch.Generator())
        sizes[layers] = sum(v.numel() for v in tree_flatten(shapes)[0])
    assert sizes[1] < kflat.MAX_FLAT_ENTRIES < sizes[2]
    rows = -(-sizes[2] // 128)
    rows += -rows % 8
    xpad = torch.empty((rows, 128), dtype=torch.float32, device="meta")
    params = torch.empty((rows // 8, 5), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="past the 2,147,483,647"):
        kflat.seg_hist2side(xpad, params, nseg=1)
    entry = dict(path="x", shape=(sizes[2],), rows=1, kind="sparse", rate=0.001, n_shards=1,
                 global_size=sizes[2])
    with pytest.raises(ValueError, match="past the 2,147,483,647"):
        ShardedFlatParamSpace.build([entry], client_axes=("data",), shard_axes=("model",),
                                    n_clients=1, shards_per_client=1,
                                    group=make_host_group("cpu"))
    assert kflat.check_flat_size(sizes[1]) == sizes[1]


def test_rwkv6_runs_on_the_fed_backend():
    """rwkv6 on the third backend: one fed round of its reduced preset (2
    clients, real SBW1 bytes both ways) with a finite loss and a
    reconciled ledger."""
    run = build_run(RunSpec(preset="rwkv6_1p6b", backend="fed", clients=2, cohort=2, rounds=1,
                            sparsity=0.05, batch=BATCH, seq_len=16), device="cpu")
    _, hist = run.run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    run.ledger.reconcile(rel=0.25)


def test_plain_passes_over_runs_of_blocks_equal_one_run(monkeypatch):
    """The plain histogram and moments take 65,536 blocks at a time (so
    their temporaries fit beside mixtral's 1.58 G entries on the card);
    over runs of 3 blocks they give the same counts and sums, bit for bit,
    as over one run, on a buffer of four segments."""
    from repro_torch.kernels import flat as kflat
    from torch_helpers import coarse_ranges, segment_layout

    segs, xpad, sob = segment_layout([5000, 1024, 9000, 300], seed=3)
    lo, hi = coarse_ranges(segs)
    hparams = np.concatenate([sob[:, None].astype(np.float32), lo[sob][:, :1], hi[sob][:, :1],
                              lo[sob][:, 1:], hi[sob][:, 1:]], axis=1)
    thr = np.float32(0.5)
    mparams = np.stack([sob.astype(np.float32), np.full(sob.shape, thr),
                        np.full(sob.shape, thr)], 1)
    one = (kflat.seg_hist2side_plain(t(xpad), t(hparams), nseg=4),
           kflat.seg_moments_plain(t(xpad), t(mparams), nseg=4))
    monkeypatch.setattr(kflat, "_RUN_BLOCKS", 3)
    assert len(kflat._runs(xpad.shape[0] // 8)) > 4
    runs = (kflat.seg_hist2side_plain(t(xpad), t(hparams), nseg=4),
            kflat.seg_moments_plain(t(xpad), t(mparams), nseg=4))
    for a, b in zip(one, runs):
        np.testing.assert_array_equal(n(a).view(np.int32), n(b).view(np.int32))
    assert float(one[0].sum()) > 0 and float(one[1][:, :, 1].sum()) > 0
