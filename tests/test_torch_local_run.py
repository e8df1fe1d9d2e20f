"""The port's local backend (the paper's Alg. 1 round) against the JAX
package's, on the CPU: ``LocalVmapChannel``, ``DSGDTrainer`` and
``LocalRun``, their run surface and CLI.

Inputs are made with numpy from a seed and handed to both packages:
deltas for the channel; for the run, the reference's initial parameters,
a warm Adam state (from zero moments every |ΔW| of round 1 is about lr,
and the side SBC keeps is rounding noise in either package; see
ROADMAP C) and the batches.

Tolerances:
  * the channel (``round_exchange`` on the same deltas and state) and the
    mean over clients: bit-exact (mean ΔW, transmitted ΔW*, state,
    ``bits_per_client``, client 0's compressed tree).  The mean over
    clients is XLA's f32 reduce, checked against ``jnp.mean`` under
    ``jit`` for C = 1 to 8.  The reference's ``round_exchange`` runs
    eagerly here, each op its own XLA computation: under the trainer's
    ``jit`` XLA may fuse the gather of the survivors into the reduce of
    μ and sum some sizes in another order (seen: k = 25, an 8-lane order,
    μ 1-2 ulps off the eager one), which no fixed order reproduces;
  * the run: forward and backward differ between the frameworks in their
    last ulps, so the loss is held to ``rtol=1e-5`` in round 1 and
    ``1e-4`` over three rounds; the ledger rows and the measured bits
    must be equal, which needs the same selections, and so must Eq. 1
    bits (see :func:`assert_eq1_bits` for the reference's fast path);
  * ``fast=True`` against ``fast=False`` in the port: bit-exact.
"""
import contextlib
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core.channel import LocalVmapChannel as JChannel
from repro.optim.optimizers import AdamState as JAdamState
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro.run.build import policy_from_spec as j_policy_from_spec
from repro_torch.convert import params_from_jax
from repro_torch.core.channel import LocalVmapChannel, mean_over_clients
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.tree import tree_map
from repro_torch.data import client_batches
from repro_torch.data.synthetic import make_classification_task
from repro_torch.optim.optimizers import AdamState
from repro_torch.run import RunSpec, build_run, policy_from_spec
from repro_torch.train import DSGDTrainer, TrainState
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

LENET = {"c1": (5, 5, 1, 4), "c2": (5, 5, 4, 8), "f1": (128, 50), "f1b": (50,),
         "f2": (50, 10), "f2b": (10,)}


def bits_equal(a, b, what=""):
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    view = np.uint32 if a.dtype.kind == "f" else a.dtype
    np.testing.assert_array_equal(a.view(view), b.view(view), err_msg=what)


# ------------------------------------------------------ mean over clients


@pytest.mark.parametrize("clients", [1, 2, 3, 4, 5, 8])
def test_mean_over_clients_is_jnp_mean(clients):
    rng = np.random.default_rng(clients)
    d = (rng.standard_normal((clients, 5000)) * np.exp(rng.standard_normal((clients, 5000)))
         ).astype(np.float32)
    d[:, :40] = 0.0
    d[:, 20:40] = -0.0
    d[0, 40:60] = -0.0
    d[:, 60:80] = d[:1, 60:80]  # equal rows, whose mean may round away from the row
    want = jax.jit(lambda x: jnp.mean(x, axis=0))(jnp.asarray(d))
    bits_equal(mean_over_clients(t(d)), want, f"C={clients}")
    bits_equal(mean_over_clients(t(d[:, 0])), jnp.mean(jnp.asarray(d[:, 0])))


# ------------------------------------------------------------- the channel


def deltas_for(seed, clients):
    rng = np.random.default_rng(seed)
    out = {k: (0.01 * rng.standard_normal((clients,) + s)).astype(np.float32)
           for k, s in LENET.items()}
    out["f2b"][:, :3] = 0.0
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
@pytest.mark.parametrize("clients", [1, 3])
@pytest.mark.parametrize("dense", ["", "^f[12]b$"], ids=["sbc", "dense-biases"])
def test_round_exchange_matches_jax(fast, clients, dense):
    spec = dict(compressor="sbc", fast=fast, dense_pattern=dense or None)
    jch = JChannel(compressor=_compressor(j_policy_from_spec(JRunSpec(**spec))),
                   n_clients=clients)
    tch = LocalVmapChannel(compressor=_compressor(policy_from_spec(RunSpec(**spec))),
                           n_clients=clients)
    like = {k: np.zeros(s, np.float32) for k, s in LENET.items()}
    jstate = jch.init_state(jax.tree.map(jnp.asarray, like), jax.random.PRNGKey(0))
    tstate = tch.init_state(tree_map(t, like))
    rates = jch.resolved(jax.tree.map(jnp.asarray, like)).rates(0.05)
    def step(d, s):  # eager: each reference op is its own XLA computation
        return jch.round_exchange(d, s, rates, return_compressed=True)

    for r in range(2):
        d = deltas_for(r, clients)
        jex = step(jax.tree.map(jnp.asarray, d), jstate)
        tex = tch.round_exchange(tree_map(t, d), tstate, rates, return_compressed=True)
        for key in LENET:
            bits_equal(tex.mean_delta[key], jex.mean_delta[key], f"round {r + 1} mean {key}")
            bits_equal(tex.transmitted[key], jex.transmitted[key], f"transmitted {key}")
            for field in LeafCompressed._fields:
                bits_equal(getattr(tex.compressed0[key], field),
                           getattr(jex.compressed0[key], field), f"{key}.{field}")
        jres, tres = jax.tree.leaves(jex.state.residual), tex.state.residual
        for a, b in zip(jres, [tres] if fast else [tres[k] for k in sorted(tres)]):
            bits_equal(a, b, f"round {r + 1} residual")
        assert [int(s) for s in tex.state.step] == [r + 1] * clients
        bits_equal(tex.bits_per_client, jex.bits_per_client, "bits_per_client")
        jstate, tstate = jex.state, tex.state


def _compressor(policy):
    from repro.core.api import Compressor as JCompressor
    from repro_torch.core.api import Compressor as TCompressor

    cls = JCompressor if type(policy).__module__.startswith("repro.") else TCompressor
    return policy if isinstance(policy, cls) else cls.from_policy(policy.name, policy)


def test_flat_path_launches_one_mean_per_segment_whatever_the_clients(monkeypatch):
    """Every SBC segment's C rows go through one two-sided top-k, so the
    exact engine's f32_mean_xla calls a round do not grow with C; the
    per-leaf path takes two per SBC leaf and client."""
    from repro_torch.kernels import topk
    from repro_torch.core import stages

    calls = []
    for mod in (topk, stages):
        real = mod.f32_mean_xla
        monkeypatch.setattr(mod, "f32_mean_xla",
                            lambda x, *a, real=real, **k: calls.append(x.shape) or real(x, *a, **k))
    like = {k: np.zeros(s, np.float32) for k, s in LENET.items()}
    for fast, want in ((True, [(6, k) for k in (5, 40, 320, 2, 25, 1)]), (False, 6 * 3 * 2)):
        ch = LocalVmapChannel(compressor=_compressor(policy_from_spec(
            RunSpec(compressor="sbc", fast=fast))), n_clients=3)
        calls.clear()
        ch.round_exchange(tree_map(t, deltas_for(0, 3)), ch.init_state(tree_map(t, like)),
                          0.05)
        assert (sorted(calls) == sorted(want)) if fast else len(calls) == want


# --------------------------------------------------------------------- run


def warm_jax_state(jrun, seed=42):
    """The reference's initial local state with a warm Adam state."""
    state = jrun.init()
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32),
                     state.opt_states.m)
    v = jax.tree.map(lambda x: jnp.asarray((0.01 * rng.standard_normal(x.shape)) ** 2,
                                           jnp.float32), state.opt_states.v)
    return state._replace(opt_states=JAdamState(m, v))


def port_state_from_jax(trun, jstate):
    """The reference's TrainState carried across (parameters and Adam
    state as numpy) with the port's fresh compressor state."""
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu")
    opt = AdamState(params_from_jax(jax.tree.map(np.asarray, jstate.opt_states.m), "cpu"),
                    params_from_jax(jax.tree.map(np.asarray, jstate.opt_states.v), "cpu"))
    return TrainState(params, opt, trun.trainer.channel.init_state(params),
                      torch.zeros((), dtype=torch.int32))


def batches(clients, delay, batch, rounds, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal((clients, delay, batch, 28, 28, 1)).astype(np.float32),
             "labels": rng.integers(0, 10, (clients, delay, batch)).astype(np.int32)}
            for _ in range(rounds)]


def assert_eq1_bits(port, ref, fast):
    """Eq. 1 bits a client: equal; on the reference's fast path within one
    f32 ulp, since under ``jit`` XLA folds its per-leaf constants in
    another order (102,035.453 for LeNet5 at p = 0.01, where its per-leaf
    path, its static ``channel.bits`` and the port give 102,035.461)."""
    if fast:
        np.testing.assert_allclose(port, ref, rtol=2 ** -23)
    else:
        assert port == ref


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_local_run_matches_jax(fast):
    spec = dict(preset="lenet5", backend="local", clients=2, delay=2, batch=4,
                sparsity=0.01, rounds=3, measure_wire=True, fast=fast)
    jrun = j_build_run(JRunSpec(**spec))
    trun = build_run(RunSpec(**spec), device="cpu")
    jstate = warm_jax_state(jrun)
    tstate = port_state_from_jax(trun, jstate)
    data = batches(2, 2, 4, 3)
    jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data[r])
    trun.batch_fn = lambda r: {"images": t(data[r]["images"]),
                               "labels": t(data[r]["labels"]).long()}
    for r in range(3):
        jstate, jm = jrun.step(jstate, r)
        tstate, tm = trun.step(tstate, r)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4, err_msg=f"round {r + 1}")
        assert_eq1_bits(float(tm["bits_per_client"]), float(jm["bits_per_client"]), fast)
        assert tm["measured_bits_per_client"] == jm["measured_bits_per_client"]
        np.testing.assert_allclose(float(tm["update_norm"]), float(jm["update_norm"]),
                                   rtol=1e-3)
    t_hist, j_hist = trun.ledger.history(), jrun.ledger.history()
    for a, b in zip(t_hist.pop("up_bits_analytic"), j_hist.pop("up_bits_analytic")):
        assert_eq1_bits(a, b, fast)
    assert t_hist == j_hist
    trun.ledger.reconcile(rel=0.25)
    for k, v in tstate.params.items():
        np.testing.assert_allclose(n(v), n(jstate.params[k]), rtol=1e-4, atol=1e-6)
    assert int(tstate.round) == 3


def test_fast_and_per_leaf_local_runs_are_bit_identical():
    runs = {fast: build_run(RunSpec(preset="lenet5", backend="local", clients=3, batch=4,
                                    sparsity=0.01, rounds=3, measure_wire=True, fast=fast),
                            device="cpu") for fast in (False, True)}
    states = {fast: run.init() for fast, run in runs.items()}
    for r in range(3):
        for fast, run in runs.items():
            states[fast], _ = run.step(states[fast], r)
    slow, fast = states[False], states[True]
    space = runs[True].trainer.resolved(fast.params).flat_space(fast.params)
    for k in slow.params:
        bits_equal(fast.params[k], slow.params[k], f"params {k}")
        bits_equal(space.unflatten(fast.comp_state.residual)[k], slow.comp_state.residual[k],
                   f"residual {k}")
        for a, b in ((fast.opt_states.m, slow.opt_states.m), (fast.opt_states.v, slow.opt_states.v)):
            bits_equal(a[k], b[k], f"adam {k}")
    assert runs[True].ledger.history() == runs[False].ledger.history()


# the decoder presets' cases that were refused here run now
# (tests/test_torch_decoder_run.py)


def test_local_run_without_a_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_run(RunSpec(preset="lenet5", backend="local"))
    assert build_run(RunSpec(preset="lenet5", backend="local"), device="cpu").device.type == "cpu"


def test_direct_trainer_construction_warns():
    from repro_torch.models.model import build_model
    from repro_torch.configs.base import get_config
    from repro_torch.optim import get_optimizer

    with pytest.warns(DeprecationWarning, match="build_run"):
        DSGDTrainer(model=build_model(get_config("lenet5")),
                    compressor=policy_from_spec(RunSpec()), optimizer=get_optimizer("adam"),
                    n_clients=2, lr=lambda it: 1e-3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        build_run(RunSpec(preset="lenet5", backend="local"), device="cpu")


def test_client_batches_layout():
    task = make_classification_task(n_classes=10, img_size=28, channels=1, batch=4,
                                    device="cpu")
    b = client_batches(task, 3, 2)(5)
    assert tuple(b["images"].shape) == (3, 2, 4, 28, 28, 1)
    assert tuple(b["labels"].shape) == (3, 2, 4)
    for c in range(3):
        for d in range(2):
            assert torch.equal(b["images"][c, d], task.sample(5 * 2 + d, c)["images"])


@pytest.mark.parametrize("fast", [[], ["--fast"]], ids=["per-leaf", "fast"])
def test_cli_local_backend_ends_with_the_wire_line(fast):
    from repro_torch.run.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = main(["--preset", "lenet5", "--backend", "local", "--sparsity", "0.01",
                     "--rounds", "2", "--batch", "4", "--clients", "2", "--measure-wire",
                     "--device", "cpu", *fast])
    lines = out.getvalue().strip().splitlines()
    assert lines[0].startswith("run: backend=local") and f"fast={bool(fast)}" in lines[0]
    assert lines[-1].startswith("wire: up ") and "measured/analytic up" in lines[-1]
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()


def test_train_launcher_prints_the_policy_and_trains(tmp_path):
    from repro_torch.launch.train import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--preset", "lenet5", "--print-policy", "--device", "cpu",
              "--dense-pattern", "^f[12]b$"])
    assert "f1b" in out.getvalue() and "dense" in out.getvalue()
    save = tmp_path / "params.npz"
    with contextlib.redirect_stdout(io.StringIO()):
        hist = main(["--preset", "lenet5", "--rounds", "2", "--batch", "4", "--clients", "2",
                     "--device", "cpu", "--save", str(save), "--log-every", "1"])
    assert save.exists() and len(hist["loss"]) == 2


def test_run_and_fit_are_the_step_loop():
    """``LocalRun.run`` and ``DSGDTrainer.fit`` go through the metered
    round of ``LocalRun.step``: the same history, ledger rows and params,
    bit for bit."""
    spec = RunSpec(preset="lenet5", backend="local", clients=2, batch=4, sparsity=0.01,
                   rounds=2, measure_wire=True)
    by_run, by_step, by_fit = (build_run(spec, device="cpu") for _ in range(3))
    state, hist = by_run.run()
    stepped = by_step.init()
    for r in range(spec.rounds):
        stepped, m = by_step.step(stepped, r)
        assert m["measured_bits_per_client"] == hist["measured_bits_per_client"][r]
        assert float(m["loss"]) == hist["loss"][r]
    fitted, fit_hist = by_fit.trainer.fit(None, by_fit.batch_fn, n_rounds=spec.rounds,
                                          n_delay=spec.delay, sparsity=spec.sparsity,
                                          seed=spec.seed, measure_wire=True)
    assert fit_hist == hist
    assert hist["measured_total_bits"] == sum(hist["measured_bits_per_client"])
    for other, run in ((stepped, by_step), (fitted, by_fit)):
        assert run.ledger.history() == by_run.ledger.history()
        for k in state.params:
            assert torch.equal(other.params[k], state.params[k])
