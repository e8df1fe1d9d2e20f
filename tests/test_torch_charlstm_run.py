"""The paper's CharLSTM preset on every run path of the port, against the
JAX package, on the CPU: the local channel, the local backend per leaf
and flat, the GSPMD hist and exact engines, and the CLIs.

CharLSTM's parameters are a nested tree (``cell0/wx`` …), which the
channel, the flat space, the SBW1 leaf order and the dense/skip patterns
see as the reference's ``/``-joined paths.  CharLSTM trains with SGD at
lr 1.0, so there is no Adam tie in round 1 (ROADMAP C) and every run
starts from the reference's own initial parameters, carried across, with
the reference's batches handed across.

Tolerances, as in ``tests/test_torch_local_run.py``:
  * the channel (``round_exchange`` on the same deltas and state): bit
    for bit — mean ΔW, transmitted ΔW*, residual, ``bits_per_client`` and
    client 0's compressed tree — with the reference run eagerly;
  * the runs: loss ``rtol=1e-5`` in round 1 and ``1e-4`` over three
    rounds; Eq. 1 bits equal (on the reference's jitted fast path within
    one f32 ulp).  The selections may differ at a segment's k-th entry:
    SGD at lr 1.0 makes ΔW = (W − g) − W, a multiple of W's ulp (about
    7e-9 for CharLSTM's weights), so the k-th and (k+1)-th |acc| of a
    segment are often one such step apart or equal, and gradients that
    differ in their last ulps between the frameworks swap them.  So the
    parameters are held to ``rtol=1e-4, atol=1e-6`` everywhere but at
    most two entries per client, SBC segment and round (a swap moves one
    μ), and the measured bits of each round to within 0.1% of the
    reference's (a swap changes two Golomb gaps); the hist engine may
    also select differently next to a bucket edge.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core.channel import LocalVmapChannel as JChannel
from repro.models.model import build_model as j_build_model
from repro.configs.base import get_config as j_get_config
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro.run.build import policy_from_spec as j_policy_from_spec
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.channel import LocalVmapChannel
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.run import RunSpec, build_run, policy_from_spec
from repro_torch.train import TrainState
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

P = 0.01
LOCAL = dict(preset="charlstm", backend="local", clients=2, delay=2, batch=2, seq_len=8,
             sparsity=P, rounds=3, measure_wire=True)
GSPMD = dict(preset="charlstm", backend="gspmd", fast=True, batch=2, seq_len=8,
             sparsity=P, rounds=3)


def bits_equal(a, b, what=""):
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    view = np.uint32 if a.dtype.kind == "f" else a.dtype
    np.testing.assert_array_equal(a.view(view), b.view(view), err_msg=what)


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def shapes():
    """The full-width CharLSTM tree of shapes (the reference's)."""
    a = jax.eval_shape(j_build_model(j_get_config("charlstm")).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: tuple(x.shape), a, is_leaf=lambda x: hasattr(x, "shape"))


def _compressor(policy):
    from repro.core.api import Compressor as JCompressor
    from repro_torch.core.api import Compressor as TCompressor

    cls = JCompressor if type(policy).__module__.startswith("repro.") else TCompressor
    return policy if isinstance(policy, cls) else cls.from_policy(policy.name, policy)


def deltas_for(shapes, seed, clients):
    """Per-client ΔW trees: SGD-like steps with the embedding rows of
    unseen tokens exactly zero."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(
        lambda s: (0.01 * rng.standard_normal((clients,) + s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    out["embed"]["embedding"][:, rng.choice(98, 60, replace=False)] = 0.0
    return out


# ------------------------------------------------------------- the channel


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
@pytest.mark.parametrize("dense", ["", "b$"], ids=["sbc", "dense-biases"])
def test_round_exchange_matches_jax(shapes, fast, dense):
    clients = 2
    spec = dict(compressor="sbc", fast=fast, dense_pattern=dense or None)
    jch = JChannel(compressor=_compressor(j_policy_from_spec(JRunSpec(**spec))),
                   n_clients=clients)
    tch = LocalVmapChannel(compressor=_compressor(policy_from_spec(RunSpec(**spec))),
                           n_clients=clients)
    like = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    jstate = jch.init_state(jax.tree.map(jnp.asarray, like), jax.random.PRNGKey(0))
    tstate = tch.init_state(tree_map(t, like))
    rates = jch.resolved(jax.tree.map(jnp.asarray, like)).rates(P)
    paths = ["cell0/b", "cell0/wh", "cell0/wx", "cell1/b", "cell1/wh", "cell1/wx",
             "embed/embedding", "head/w"]
    assert [pl.path for pl in tch.resolved(tree_map(t, like)).plans] == paths
    for r in range(2):
        d = deltas_for(shapes, r, clients)
        jex = jch.round_exchange(jax.tree.map(jnp.asarray, d), jstate, rates,
                                 return_compressed=True)  # eager
        tex = tch.round_exchange(tree_map(t, d), tstate, rates, return_compressed=True)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jex.mean_delta)[0],
                                tree_flatten(tex.mean_delta)[0]):
            bits_equal(b, a, f"round {r + 1} mean {path}")
        for a, b in zip(jax.tree.leaves(jex.transmitted), tree_flatten(tex.transmitted)[0]):
            bits_equal(b, a, "transmitted")
        jc = jax.tree.leaves(jex.compressed0, is_leaf=lambda x: hasattr(x, "_fields"))
        for a, b in zip(jc, tree_flatten(tex.compressed0)[0]):
            for field in LeafCompressed._fields:
                bits_equal(getattr(b, field), getattr(a, field), field)
        jres = jax.tree.leaves(jex.state.residual)
        tres = [tex.state.residual] if fast else tree_flatten(tex.state.residual)[0]
        for a, b in zip(jres, tres):
            bits_equal(b, a, f"round {r + 1} residual")
        bits_equal(tex.bits_per_client, jex.bits_per_client, "bits_per_client")
        jstate, tstate = jex.state, tex.state
    if dense:  # the biases ride dense: ΔW* there is the mean itself
        for c in ("cell0", "cell1"):
            assert (n(tex.transmitted[c]["b"]) != 0).all()


# --------------------------------------------------------------------- runs


def lm_batches(lead, rounds, seed=0, batch=2, seq_len=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        toks = rng.integers(0, 98, lead + (batch, seq_len + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def t_batch(b):
    return {k: t(v).long() for k, v in b.items()}


def port_local_state(trun, jstate):
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu")
    assert jstate.opt_states == ()  # SGD
    return TrainState(params, (), trun.trainer.channel.init_state(params),
                      torch.zeros((), dtype=torch.int32))


def assert_params_close(got_tree, want_tree, swaps: int) -> None:
    """Every parameter within ``rtol=1e-4, atol=1e-6`` of the reference's
    but at most ``swaps`` entries in all (boundary swaps of the top-k)."""
    off = 0
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                                 tree_flatten(got_tree)[0]):
        off += int((~np.isclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-6)).sum())
    assert off <= swaps, f"{off} entries off the reference's, more than {swaps} swaps allow"


def assert_measured_close(port: list, ref: list) -> None:
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert abs(a - b) <= 1e-3 * b, (a, b)


def assert_eq1_bits(port, ref, fast):
    """Eq. 1 bits a client: equal; on the reference's jitted fast path
    within one f32 ulp (XLA folds its per-leaf constants in another order,
    ROADMAP C)."""
    if fast:
        np.testing.assert_allclose(port, ref, rtol=2 ** -23)
    else:
        assert port == ref


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_local_run_matches_jax(fast):
    jrun = j_build_run(JRunSpec(**LOCAL, fast=fast))
    trun = build_run(RunSpec(**LOCAL, fast=fast), device="cpu")
    jstate = jrun.init()
    tstate = port_local_state(trun, jstate)
    data = lm_batches((2, 2), 3)
    jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data[r])
    trun.batch_fn = lambda r: t_batch(data[r])
    for r in range(3):
        jstate, jm = jrun.step(jstate, r)
        tstate, tm = trun.step(tstate, r)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4, err_msg=f"round {r + 1}")
        assert_eq1_bits(float(tm["bits_per_client"]), float(jm["bits_per_client"]), fast)
        assert 55_400 < float(tm["bits_per_client"]) < 55_500  # Eq. 1 at p = 0.01
    t_hist, j_hist = trun.ledger.history(), jrun.ledger.history()
    for a, b in zip(t_hist.pop("up_bits_analytic"), j_hist.pop("up_bits_analytic")):
        assert_eq1_bits(a, b, fast)
    assert_measured_close(t_hist.pop("up_bits_measured"), j_hist.pop("up_bits_measured"))
    t_hist.pop("up_bytes"), j_hist.pop("up_bytes")
    assert t_hist == j_hist
    assert_params_close(tstate.params, jstate.params, swaps=2 * 2 * 8 * 3)
    assert tstate.opt_states == () and int(tstate.round) == 3


def test_fast_and_per_leaf_local_runs_are_bit_identical():
    runs = {fast: build_run(RunSpec(**LOCAL, fast=fast), device="cpu") for fast in (False, True)}
    states = {fast: run.init() for fast, run in runs.items()}
    for r in range(2):
        for fast, run in runs.items():
            states[fast], _ = run.step(states[fast], r)
    slow, quick = states[False], states[True]
    space = runs[True].trainer.resolved(quick.params).flat_space(quick.params)
    residual = space.unflatten(quick.comp_state.residual)
    for a, b in zip(tree_flatten(quick.params)[0] + tree_flatten(residual)[0],
                    tree_flatten(slow.params)[0] + tree_flatten(slow.comp_state.residual)[0]):
        bits_equal(a, b)
    assert runs[True].ledger.history() == runs[False].ledger.history()


@pytest.mark.parametrize("engine", ["hist", "exact", "exact-dense"])
def test_gspmd_runs_match_jax(engine):
    extra = {"hist": dict(flat_engine="hist", measure_wire=True),
             "exact": dict(flat_engine="exact", device_pack=True, measure_wire=True),
             "exact-dense": dict(flat_engine="exact", device_pack=True, measure_wire=True,
                                 dense_pattern="b$")}[engine]
    jrun = j_build_run(JRunSpec(**GSPMD, **extra), mesh=one_device_mesh())
    trun = build_run(RunSpec(**GSPMD, **extra), device="cpu")
    assert trun.fns.bits_per_client == jrun.fns.bits_per_client
    assert trun.fns.bits_dense == jrun.fns.bits_dense
    if "dense_pattern" not in extra:
        assert 55_400 < trun.fns.bits_per_client < 55_500
    np_state = jax.tree.map(np.asarray, jrun.init())
    jstate, tstate = jax.tree.map(jnp.asarray, np_state), state_from_jax(np_state, "cpu")
    data = lm_batches((1,), 3, seed=1)
    jrun._batch = lambda r: jax.tree.map(jnp.asarray, data[r])
    trun._batch = lambda r: t_batch(data[r])
    for r in range(3):
        jstate, jm = jrun.step(jstate, r)
        tstate, tm = trun.step(tstate, r)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4, err_msg=f"round {r + 1}")
    assert_params_close(tstate["params"], jstate["params"], swaps=2 * 8 * 3)
    t_hist, j_hist = trun.ledger.history(), jrun.ledger.history()
    assert_measured_close(t_hist.pop("up_bits_measured"), j_hist.pop("up_bits_measured"))
    t_hist.pop("up_bytes"), j_hist.pop("up_bytes")
    assert t_hist == j_hist and len(trun.ledger.records) == 3


# ---------------------------------------------------------------------- CLI


@pytest.mark.parametrize("flags", [
    ["--backend", "local"], ["--backend", "local", "--fast"],
    ["--backend", "gspmd", "--fast", "--flat-engine", "hist"],
    ["--backend", "gspmd", "--fast", "--flat-engine", "exact", "--device-pack"],
], ids=["local", "local-fast", "gspmd-hist", "gspmd-exact"])
def test_cli_ends_with_the_wire_line(flags):
    from repro_torch.run.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = main(["--preset", "charlstm", "--sparsity", "0.01", "--rounds", "2",
                     "--batch", "2", "--seq-len", "8", "--clients", "2", "--measure-wire",
                     "--device", "cpu", *flags])
    lines = out.getvalue().strip().splitlines()
    assert lines[0].startswith(f"run: backend={flags[1]} preset=charlstm")
    assert "params=0.68M" in lines[0]
    assert lines[-1].startswith("wire: up ") and "measured/analytic up" in lines[-1]
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()


def test_train_launcher_runs_paper_lstm(tmp_path):
    from repro_torch.launch.train import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--preset", "paper-lstm", "--print-policy", "--device", "cpu",
              "--dense-pattern", "(^|/)(b|bias)$"])
    text = out.getvalue()
    assert "cell0/b" in text and "dense" in text and "head/w" in text
    save = tmp_path / "params.npz"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = main(["--preset", "paper-lstm", "--compressor", "sbc", "--sparsity", "0.01",
                     "--rounds", "2", "--clients", "2", "--batch", "2", "--seq-len", "8",
                     "--log-every", "1", "--measure-wire", "--device", "cpu",
                     "--save", str(save)])
    assert "arch=charlstm params=0.7M" in out.getvalue()
    assert "measured wire:" in out.getvalue()
    assert save.exists() and len(hist["loss"]) == 2
    with np.load(save) as z:
        assert sorted(f for f in z.files if f != "__meta__") == [
            "cell0/b", "cell0/wh", "cell0/wx", "cell1/b", "cell1/wh", "cell1/wx",
            "embed/embedding", "head/w"]
