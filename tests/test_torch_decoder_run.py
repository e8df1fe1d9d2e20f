"""The decoder presets (``tiny``, ``fed-tiny``, ``lm-100m``, the reduced
dense decoders) on the port's three backends against the JAX package's,
on the CPU.

Inputs: the reference's initial parameters and optimizer state carried
across, numpy batches from a seed, numpy deltas for the channel.
Tolerances:
  * the local channel on the same deltas (``round_exchange``, per leaf
    and flat, on tiny's tree with its stacked superblock leaves): bit for
    bit (mean ΔW, transmitted ΔW*, residual, client 0's compressed
    leaves, Eq. 1 bits);
  * one local round of ``tiny``: the loss to ``rtol=1e-6``; the measured
    bits, SBW1 bytes metered into the ledger and the ledger's rows equal;
    the survivors (ΔW*'s support) equal; the parameters within 1e-6
    (relative): the frameworks' gradients differ in their last ulp on
    some entries, which moves a segment's μ by as much;
  * ``tiny`` on the GSPMD hist engine, one rank: the loss and the
    parameters within ``rtol=1e-6``; the residual within 2e-5 of its
    largest entry (the hist engine's moments are summed in f64, ROADMAP C,
    and a survivor's residual acc − μ carries μ's difference);
  * ``fed-tiny``'s fed round with the reference launcher's dense-small
    rule: the same per-leaf plan, uploads' sizes and ledger rows, the
    loss to ``rtol=1e-5``;
  * ``lm-100m`` (137,841,408 parameters) is never drawn or stepped
    here: its Eq. 1 bits a client, from shapes, equal the reference's to
    one f32 ulp (the reference's fast path folds its constants under
    ``jit``, ROADMAP C).

The cases that ran here once raised ``NotImplementedError`` naming
ROADMAP A12 in ``tests/test_torch_slice.py``, ``test_torch_local_run.py``
and ``test_torch_fed_run.py``.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from jax.sharding import Mesh
from repro.configs.base import get_config as j_get_config
from repro.core.channel import LocalVmapChannel as JChannel
from repro.core.policy import DENSE_SMALL_PATTERN as J_DENSE_SMALL
from repro.launch.dist import build_dist_train as j_build_dist_train
from repro.models.model import build_model as j_build_model
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro.run.build import policy_from_spec as j_policy_from_spec
from repro.run.presets import lm_100m_config as j_lm_100m
from repro.run.presets import tiny_config as j_tiny
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.channel import LocalVmapChannel
from repro_torch.core.policy import DENSE_SMALL_PATTERN, path_str
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.launch.dist import build_dist_train
from repro_torch.models.model import build_model
from repro_torch.run import RunSpec, build_run, policy_from_spec
from repro_torch.run.presets import lm_100m_config, tiny_config
from repro_torch.train import TrainState
from test_torch_local_run import _compressor, assert_eq1_bits, bits_equal
from torch_fed_cases import capture_uploads, paired
from torch_helpers import n, one_thread, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SMALL = dict(batch=2, seq_len=16)


def leaf_dict(tree) -> dict:
    return {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------- the channel


def tiny_shapes() -> dict:
    a = jax.eval_shape(j_build_model(j_tiny()).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: s.shape, a)


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_round_exchange_on_tinys_tree_is_bit_for_bit(fast):
    shapes = tiny_shapes()
    rng = np.random.default_rng(7)
    deltas = jax.tree.map(lambda s: (0.01 * rng.standard_normal((2,) + s)).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    spec = dict(compressor="sbc", fast=fast)
    jch = JChannel(compressor=_compressor(j_policy_from_spec(JRunSpec(**spec))), n_clients=2)
    tch = LocalVmapChannel(compressor=_compressor(policy_from_spec(RunSpec(**spec))), n_clients=2)
    like = jax.tree.map(lambda d: d[0], deltas)
    jstate = jch.init_state(jax.tree.map(jnp.asarray, like), jax.random.PRNGKey(0))
    tstate = tch.init_state(tree_map(t, like))
    rates = jch.resolved(jax.tree.map(jnp.asarray, like)).rates(0.02)
    jex = jch.round_exchange(jax.tree.map(jnp.asarray, deltas), jstate, rates,
                             return_compressed=True)
    tex = tch.round_exchange(tree_map(t, deltas), tstate, rates, return_compressed=True)
    for name in ("mean_delta", "transmitted"):
        want = leaf_dict(getattr(jex, name))
        for p, v in tree_flatten_with_path(getattr(tex, name))[0]:
            bits_equal(v, want[path_str(p)], f"{name} {path_str(p)}")
    jcomp = jax.tree_util.tree_leaves(jex.compressed0, is_leaf=lambda x: hasattr(x, "_fields"))
    tcomp = tree_flatten(tex.compressed0)[0]
    for jc, tc in zip(jcomp, tcomp):
        for field in LeafCompressed._fields:
            bits_equal(getattr(tc, field), getattr(jc, field), field)
    jres = jax.tree.leaves(jex.state.residual)
    tres = [tex.state.residual] if fast else tree_flatten(tex.state.residual)[0]
    for a, b in zip(jres, tres):
        bits_equal(a, b, "residual")
    bits_equal(tex.bits_per_client, jex.bits_per_client, "bits_per_client")


# ------------------------------------------------------------ local round


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_tiny_local_round_matches_the_reference(fast):
    spec = dict(preset="tiny", backend="local", clients=2, sparsity=0.02, rounds=1,
                measure_wire=True, fast=fast, **SMALL)
    jrun, trun = j_build_run(JRunSpec(**spec)), build_run(RunSpec(**spec), device="cpu")
    jstate = jrun.init()
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
    tstate = TrainState(params, params_from_jax(jax.tree.map(np.asarray, jstate.opt_states),
                                                "cpu"),
                        trun.trainer.channel.init_state(params), torch.zeros((), dtype=torch.int32))
    toks = np.random.default_rng(0).integers(0, 97, (2, 1, 2, 17)).astype(np.int32)
    data = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data)
    trun.batch_fn = lambda r: {k: t(v).long() for k, v in data.items()}
    jstate2, jm = jrun.step(jstate, 0)
    tstate2, tm = trun.step(tstate, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    assert_eq1_bits(float(tm["bits_per_client"]), float(jm["bits_per_client"]), fast)
    assert tm["measured_bits_per_client"] == jm["measured_bits_per_client"]
    t_hist, j_hist = trun.ledger.history(), jrun.ledger.history()
    for a, b in zip(t_hist.pop("up_bits_analytic"), j_hist.pop("up_bits_analytic")):
        assert_eq1_bits(a, b, fast)
    assert t_hist == j_hist
    want, before = leaf_dict(jstate2.params), leaf_dict(jstate.params)
    for p, v in tree_flatten_with_path(tstate2.params)[0]:
        k = path_str(p)
        moved_t, moved_j = n(v) != before[k], want[k] != before[k]
        np.testing.assert_array_equal(moved_t, moved_j, err_msg=f"{k}: survivors")
        np.testing.assert_allclose(n(v), want[k], rtol=1e-6, atol=1e-9, err_msg=k)


# ---------------------------------------------------------------- gspmd


def test_tiny_gspmd_hist_round_matches_the_reference():
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jfns = j_build_dist_train(j_tiny(), mesh, compressor="sbc", sparsity=0.02, fast=True,
                              flat_engine="hist")
    tfns = build_dist_train(tiny_config(), sparsity=0.02, fast=True, flat_engine="hist",
                            device="cpu")
    assert tfns.bits_per_client == jfns.bits_per_client
    assert tfns.bits_dense == jfns.bits_dense
    np_state = jax.tree.map(np.asarray, jfns.init_state(jax.random.PRNGKey(0)))
    jstate = jax.tree.map(jnp.asarray, np_state)
    tstate = state_from_jax(np_state, device="cpu")
    toks = np.random.default_rng(1).integers(0, 97, (1, 2, 17)).astype(np.int32)
    jstate, jm = jfns.train_step(jstate, {"tokens": jnp.asarray(toks[..., :-1]),
                                          "labels": jnp.asarray(toks[..., 1:])})
    tstate, tm = tfns.train_step(tstate, {"tokens": t(toks[..., :-1]).long(),
                                          "labels": t(toks[..., 1:]).long()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    want = leaf_dict(jstate["params"])
    for p, v in tree_flatten_with_path(tstate["params"])[0]:
        np.testing.assert_allclose(n(v), want[path_str(p)], rtol=1e-6, atol=1e-9,
                                   err_msg=path_str(p))
    # a survivor's residual is acc − μ, and μ's f64 sum moves it by up to
    # about 1e-5 of μ against the reference's f32 one
    res = np.asarray(jstate["residual"])
    np.testing.assert_allclose(n(tstate["residual"]), res, rtol=1e-6,
                               atol=2e-5 * float(np.abs(res).max()))


# ------------------------------------------------------------------ fed


def test_fed_tiny_round_with_the_launchers_dense_small_rule():
    assert DENSE_SMALL_PATTERN == J_DENSE_SMALL
    spec = dict(preset="fed-tiny", backend="fed", clients=2, cohort=2, rounds=1, lr=0.05,
                sparsity=0.01, dense_pattern=DENSE_SMALL_PATTERN, **SMALL)
    _, jsched, _, tsched = paired(spec)
    assert tsched.pool.resolved(tsched.server.params).describe() == \
        jsched.pool.resolved(jsched.server.params).describe()
    jlog, tlog = capture_uploads(jsched), capture_uploads(tsched)
    jm, tm = jsched.step(0), tsched.step(0)
    assert [c for c, _ in tlog[0]] == [c for c, _ in jlog[0]]
    assert [len(b) for _, b in tlog[0]] == [len(b) for _, b in jlog[0]]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    assert tsched.ledger.history() == jsched.ledger.history()
    tsched.ledger.reconcile(rel=0.1)


def test_fed_launcher_runs_its_default_preset():
    """``python -m repro_torch.launch.fed`` with the reference's defaults
    (fed-tiny, the dense-small rule, delay 3) on 4 clients, one round."""
    from repro_torch.launch.fed import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = main(["--device", "cpu", "--rounds", "1", "--clients", "4"])
    text = out.getvalue()
    assert text.startswith("fed: 4 clients (cohort 4)") and "params=0.33M" in text
    assert "policy 'sbc+rules'" in text
    assert text.strip().splitlines()[-1].startswith("wire: up ")
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


# ------------------------------------------- cases once refused (ROADMAP A12)

SLICE = dict(preset="lenet5", backend="gspmd", fast=True, flat_engine="hist", sparsity=0.01)
LOCAL = dict(preset="lenet5", backend="local")
FED = dict(preset="lenet5", backend="fed", batch=16, sparsity=0.01)


def _lm_100m_bits(spec: dict) -> tuple:
    """Eq. 1 bits a client for an lm-100m ``spec`` in (the port, the
    reference), from shapes: what a run builds its step from, without its
    LM task (a 32,000² transition table, 4 GB in f32) and without drawing
    the parameters."""
    from repro_torch.run.build import as_policy
    from repro.run.build import as_policy as j_as_policy

    if spec["backend"] == "gspmd":
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        kw = dict(compressor=spec.get("compressor", "sbc"), sparsity=spec["sparsity"],
                  fast=True, flat_engine=spec["flat_engine"])
        tfns = build_dist_train(lm_100m_config(), device="cpu", **kw)
        jfns = j_build_dist_train(j_lm_100m(), mesh, **kw)
        assert tfns.bits_dense == jfns.bits_dense == 32.0 * 137_841_408
        return tfns.bits_per_client, jfns.bits_per_client
    with torch.device("meta"):
        shapes = build_model(lm_100m_config()).init(torch.Generator())
    tch = LocalVmapChannel(compressor=_compressor(as_policy(policy_from_spec(RunSpec(**spec)))),
                           n_clients=1)
    jshapes = jax.eval_shape(j_build_model(j_lm_100m()).init, jax.random.PRNGKey(0))
    jch = JChannel(compressor=_compressor(j_as_policy(j_policy_from_spec(JRunSpec(**spec)))),
                   n_clients=1)
    return (tch.bits(shapes, tch.resolved(shapes).rates(spec["sparsity"], 0)).per_client,
            jch.bits(jshapes, jch.resolved(jshapes).rates(spec["sparsity"], 0)).per_client)


@pytest.mark.parametrize("spec", [
    # tests/test_torch_slice.py
    {**SLICE, **dict(backend="fed", preset="tiny")},
    {**SLICE, **dict(flat_engine="exact", compressor="signsgd", preset="fed-tiny")},
    {**SLICE, **dict(preset="tiny")},
    {**SLICE, **dict(compressor="topk", preset="lm-100m")},
    {**SLICE, **dict(preset="lm-100m")},
    {**SLICE, **dict(dense_pattern="b$", backend="local", compressor="topk", preset="tiny")},
    {**SLICE, **dict(skip_pattern="f2", preset="tiny")},
    # tests/test_torch_local_run.py
    {**LOCAL, **dict(preset="tiny")},
    {**LOCAL, **dict(compressor="topk", preset="fed-tiny")},
    # tests/test_torch_fed_run.py
    {**FED, **dict(preset="fed-tiny")},
    {**FED, **dict(compressor="dgc", preset="lm-100m")},
], ids=["slice-fed-tiny", "slice-signsgd-fed-tiny", "slice-tiny", "slice-topk-lm-100m",
        "slice-lm-100m", "slice-local-topk-tiny", "slice-skip-tiny", "local-tiny",
        "local-topk-fed-tiny", "fed-fed-tiny", "fed-dgc-lm-100m"])
def test_decoder_presets_once_refused_now_run(spec):
    """One round on the CPU for the small presets (finite loss); for
    lm-100m the functions a run is built from give the reference's Eq. 1
    bits a client from shapes, without a step (its 137.8 M parameters and
    its task's 32,000² table are never drawn here)."""
    if spec["preset"] == "lm-100m":
        port, ref = _lm_100m_bits(spec)
        assert port == pytest.approx(ref, rel=2 ** -23)
        if spec.get("compressor") == "topk":  # gspmd's dense fallback (ROADMAP C)
            assert port == 32.0 * 137_841_408
        return
    _, hist = build_run(RunSpec(**{**spec, **SMALL, "rounds": 1}), device="cpu").run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


@pytest.mark.parametrize("preset", ["gemma3_1b", "qwen15_4b"])
@pytest.mark.parametrize("backend", ["local", "gspmd", "fed"])
def test_reduced_dense_decoders_run_on_every_backend(preset, backend):
    spec = dict(preset=preset, backend=backend, rounds=1, sparsity=0.05, clients=2,
                **SMALL)
    if backend == "gspmd":
        spec.update(fast=True, flat_engine="exact", device_pack=True, measure_wire=True)
    _, hist = build_run(RunSpec(**spec), device="cpu").run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


@pytest.mark.parametrize("preset", ["granite_20b", "command_r_35b"])
def test_pod_mode_decoders_run_locally_and_meet_the_pod_refusal_on_gspmd(preset):
    """The pod-mode decoders run on every backend: on gspmd (ROADMAP A12,
    part 3, item 6) as one client a pod, on the default layout (one shard)
    and on a layout of 2 x 2 shards (the MLP stacks, 1 MiB, split over
    "model"): the same first loss, and each layout's Eq. 1 bits the
    reference's (``test_torch_pod_run.reference_bits``)."""
    from repro.configs.base import reduced as j_reduced
    from test_torch_pod_run import reference_bits

    spec = dict(preset=preset, rounds=1, sparsity=0.05, clients=2, **SMALL)
    _, hist = build_run(RunSpec(backend="local", **spec), device="cpu").run()
    assert np.isfinite(hist["loss"][0])
    losses, bits = [], []
    for mesh_shape in (None, {"pod": 1, "data": 2, "model": 2}):
        run = build_run(RunSpec(backend="gspmd", **spec), device="cpu", mesh_shape=mesh_shape)
        assert run.n_clients == 1 and run.fns.flat_space is None  # the bf16 residual
        _, hist = run.run()
        losses.append(hist["loss"][0])
        bits.append(run.fns.bits_per_client)
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    jcfg = j_reduced(j_get_config(preset))
    assert bits == [reference_bits(jcfg, layout, 0.05, fast=False)["eq1"] for layout in
                    ({"data": 1, "model": 1}, {"pod": 1, "data": 2, "model": 2})]
    assert bits[0] != bits[1]
    with pytest.raises(ValueError, match="layout of the gspmd backend"):
        build_run(RunSpec(backend="local", **spec), device="cpu", mesh_shape={"data": 1})


@pytest.mark.parametrize("spec", [
    dict(preset="mixtral_8x7b", backend="local"), dict(preset="llama4_maverick_400b_a17b"),
    dict(preset="jamba_v01_52b", backend="fed"), dict(preset="rwkv6_1p6b"),
    dict(preset="seamless_m4t_medium"), dict(preset="phi3_vision_4p2b"),
    dict(preset="fed-tiny", backend="fed", non_iid=True),
    dict(preset="gemma3_1b", backend="fed", non_iid=True),
    dict(preset="seamless_m4t_medium", backend="fed", non_iid=True),
])
def test_the_rest_of_the_zoo_still_raises(spec):
    """The MoE and recurrent presets (ROADMAP A12, part 3, items 1 and 2),
    the encoder-decoder and the vision prefix (items 3 and 4) and
    ``non_iid`` on a decoder preset (item 5) run one round now (held
    against the reference in tests/test_torch_zoo_run.py,
    test_torch_encdec.py, test_torch_vision_prefix.py and
    test_torch_noniid.py); ``non_iid`` on the encoder-decoder raises the
    reference's ``ValueError``, word for word."""
    run_spec = {**spec, **SMALL, "rounds": 1, "clients": 2, "sparsity": 0.05}
    if spec.get("non_iid") and spec["preset"] == "seamless_m4t_medium":
        with pytest.raises(ValueError, match="non_iid needs an LM preset") as got:
            build_run(RunSpec(**run_spec), device="cpu")
        with pytest.raises(ValueError) as want:
            j_build_run(JRunSpec(**run_spec))
        assert str(got.value) == str(want.value)
        return
    with one_thread():  # a sort a leaf in the codec: no use contending for cores
        _, hist = build_run(RunSpec(**run_spec), device="cpu").run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


def test_lm_100m_is_the_train_launchers_default_and_dist_launcher_runs_tiny():
    from repro_torch.launch import dist, train

    args = train.build_parser().parse_args([])
    assert (args.preset, args.seq_len, args.clients) == ("lm-100m", 256, 4)
    assert dist.build_parser().parse_args([]).preset == "tiny"
    assert dataclasses.asdict(lm_100m_config())["dtype"] == torch.float32
    assert lm_100m_config().param_count() == j_lm_100m().param_count()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = dist.main(["--rounds", "1", "--device", "cpu", "--batch", "2",
                          "--seq-len", "16", "--fast", "--flat-engine", "hist"])
    assert out.getvalue().startswith("gspmd: 1 clients over 1 process(es)")
    assert np.isfinite(hist["loss"][0])


def test_chip_smoke_pins_are_the_references():
    """``chip_smoke.py`` phase 12 holds lm-100m's Eq. 1 bits a client
    (``LM100M_EQ1``) and its and gemma3-1b's layouts to these pins: the
    reference's, from shapes, and the port's."""
    from torch_helpers import load_chip_smoke

    smoke = load_chip_smoke()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jfns = j_build_dist_train(j_lm_100m(), mesh, compressor="sbc",
                              sparsity=smoke.LM100M["sparsity"], fast=True, flat_engine="hist")
    assert jfns.bits_per_client == smoke.LM100M_EQ1["gspmd"]
    segs = jfns.flat_space.segments
    assert (len(segs), sum(s.rows for s in segs)) == (smoke.LM100M_LEAVES, smoke.LM100M_ROWS)
    spec = {k: v for k, v in smoke.LM100M_LOCAL.items() if k != "measure_wire"}
    port, ref = _lm_100m_bits(spec)
    assert port == ref == smoke.LM100M_EQ1["local"]
    assert build_dist_train(lm_100m_config(), sparsity=smoke.LM100M["sparsity"], fast=True,
                            flat_engine="hist", device="cpu").bits_per_client == \
        smoke.LM100M_EQ1["gspmd"]
    shapes = jax.eval_shape(j_build_model(j_get_config("gemma3_1b")).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)) == smoke.GEMMA3_PARAMS
    assert smoke.SERVE_REF_Q_CHUNK * 3 == 2049 and "--full-size" in smoke.SERVE_ARGV
