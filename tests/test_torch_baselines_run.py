"""The paper's baseline compressors on the port's three backends against
the JAX package's, on the CPU: one local round per compressor (per leaf
and on the flat space), the GSPMD backend's dense exchange for every name
but ``sbc``, and fed rounds under ``topk`` and ``signsgd``.

Inputs are made with numpy from a seed and handed to both packages: the
reference's initial parameters, a warm Adam state (ROADMAP C) and the
batches.

Tolerances:
  * local: the loss to ``rtol=1e-5``; Eq. 1 bits a client, the measured
    bits and the ledger rows equal (Eq. 1 within one f32 ulp on the
    reference's fast path, as ``tests/test_torch_local_run.py`` holds
    it); the params to ``rtol=1e-4, atol=1e-6`` for the deterministic
    compressors.  The stochastic ones (``terngrad``, ``qsgd``,
    ``randomk``) draw from torch generators, so only their loss, bits and
    ledger rows are held; the port's two paths are bit-identical for every
    compressor;
  * GSPMD: a non-``sbc`` name takes the reference's dense exchange,
    40,192,320 bits a client on LeNet5 (32 x 1,256,010), and the round's
    params equal the reference's to ``rtol=1e-4``.  Max pooling routes a
    window's gradient to its largest entry, so where two entries are
    within the convolutions' f32 rounding of each other either package
    may route it to the other one and move c1's and c2's gradients by
    1%: the test's batch has every pool window's top two entries at least
    ``POOL_GAP`` of the map's largest apart, in f64, and checks it;
  * fed: ``topk`` at lr 0 from a seeded residual gives the reference's
    upload bytes, ledger rows and server params bit for bit; ``signsgd``
    trained gives the reference's ledger rows, and the port's server fed
    the reference's uploads gives the reference's params bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.optim.optimizers import AdamState as JAdamState
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.tree import tree_flatten
from repro_torch.optim.optimizers import AdamState
from repro_torch.run import RunSpec, build_run
from repro_torch.train import TrainState
from torch_fed_cases import LENET, bits_equal, capture_uploads, paired, trees_bits_equal
from torch_helpers import load_chip_smoke, n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

BASELINES = ["none", "fedavg", "topk", "dgc", "dgc_policy", "signsgd", "onebit", "terngrad",
             "qsgd", "randomk", "variance"]
STOCHASTIC = ("terngrad", "qsgd", "randomk")
LENET5_PARAMS = 1_256_010
# 10x the largest f32 error of a LeNet5 convolution seen on the CPU
# against f64 (1e-6 of the map's largest entry, oneDNN's)
POOL_GAP = 1e-5


def warm_jax_state(jrun, seed=42):
    """The reference's initial state with a warm Adam state whose
    √v is at least 0.01.  The dense baselines send every coordinate, and
    where v is about 0 Adam's step m/√v turns the frameworks' last-ulp
    gradient differences into differences of 1e-3 relative (seen at
    v = 4e-15); top-k and SBC keep few of those."""
    state = jrun.init()
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32),
                     state.opt_states.m)
    v = jax.tree.map(lambda x: jnp.asarray((0.01 * (1 + np.abs(rng.standard_normal(x.shape))))
                                           ** 2, jnp.float32), state.opt_states.v)
    return state._replace(opt_states=JAdamState(m, v))


def port_state_from_jax(trun, jstate):
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu")
    opt = AdamState(params_from_jax(jax.tree.map(np.asarray, jstate.opt_states.m), "cpu"),
                    params_from_jax(jax.tree.map(np.asarray, jstate.opt_states.v), "cpu"))
    return TrainState(params, opt, trun.trainer.channel.init_state(params),
                      torch.zeros((), dtype=torch.int32))


def batch(clients, delay, size, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((clients, delay, size, 28, 28, 1)).astype(np.float32),
            "labels": rng.integers(0, 10, (clients, delay, size)).astype(np.int32)}


# ------------------------------------------------------------------- local


@pytest.mark.parametrize("name", BASELINES)
def test_local_round_matches_the_reference(name):
    """One round of the reference and of the port's two paths."""
    spec = dict(preset="lenet5", backend="local", compressor=name, clients=2, delay=2,
                batch=4, sparsity=0.01, rounds=1, measure_wire=True)
    jrun = j_build_run(JRunSpec(**spec))
    jstate = warm_jax_state(jrun)
    data = batch(2, 2, 4)
    jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data)
    jstate, jm = jrun.step(jstate, 0)
    ports = {}
    for fast in (False, True):
        trun = build_run(RunSpec(**spec, fast=fast), device="cpu")
        trun.batch_fn = lambda r: {"images": t(data["images"]),
                                   "labels": t(data["labels"]).long()}
        tstate, tm = trun.step(port_state_from_jax(trun, warm_jax_state(jrun)), 0)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["bits_per_client"]), float(jm["bits_per_client"]),
                                   rtol=2 ** -23)
        assert tm["measured_bits_per_client"] == jm["measured_bits_per_client"]
        th, jh = trun.ledger.history(), jrun.ledger.history()
        np.testing.assert_allclose(th.pop("up_bits_analytic"), jh.pop("up_bits_analytic"),
                                   rtol=2 ** -23)
        assert th == jh
        if name not in STOCHASTIC:
            for k, v in tstate.params.items():
                np.testing.assert_allclose(n(v), n(jstate.params[k]), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
        ports[fast] = (trun, tstate)
    # the flat and the per-leaf path: bit-identical (the same generators)
    (slow_run, slow), (_, quick) = ports[False], ports[True]
    for k in slow.params:
        bits_equal(quick.params[k], slow.params[k], f"params {k}")
    assert ports[True][0].ledger.history() == slow_run.ledger.history()


def test_local_fedavg_carries_no_residual_and_none_does():
    for name, residual in (("fedavg", ()), ("none", "tree")):
        run = build_run(RunSpec(preset="lenet5", backend="local", compressor=name, clients=2,
                                batch=4), device="cpu")
        state = run.init()
        assert (state.comp_state.residual == ()) == (residual == ())


# ------------------------------------------------------------------- gspmd


def pool_gaps(params, images) -> tuple:
    """For each of LeNet5's two max pools, in f64: the smallest gap
    between a window's two largest entries over the map's largest."""
    import torch.nn.functional as F
    from repro_torch.models.cnn import conv

    x, gaps = images.double().permute(0, 3, 1, 2), []
    for name in ("c1", "c2"):
        y = conv(params[name].double(), x)
        w = y.unfold(2, 2, 2).unfold(3, 2, 2)
        top = w.reshape(*w.shape[:4], 4).topk(2, dim=-1).values
        gaps.append(float(((top[..., 0] - top[..., 1]) / y.abs().amax()).min()))
        x = F.max_pool2d(y, 2)
    return tuple(gaps)


@pytest.mark.parametrize("name", ["topk", "signsgd", "dgc_policy", "fedavg"])
def test_gspmd_takes_the_reference_dense_exchange(name):
    spec = dict(preset="lenet5", backend="gspmd", compressor=name, batch=4, sparsity=0.01,
                rounds=1)
    jrun = j_build_run(JRunSpec(**spec))
    trun = build_run(RunSpec(**spec), device="cpu")
    assert trun.fns.bits_per_client == jrun.fns.bits_per_client == 32 * LENET5_PARAMS
    assert trun.fns.bits_dense == jrun.fns.bits_dense
    assert {gl.mode for gl in trun.channel.leaves} == {"dense"}
    # a warm Adam state (from zero moments Adam's step is ±lr by the
    # gradient's sign, which ulps flip where the gradient is about 0),
    # as numpy copies: the reference's step donates its state's buffers
    rng = np.random.default_rng(42)
    np_state = jax.tree.map(np.array, jrun.init())
    np_state["opt"] = JAdamState(
        jax.tree.map(lambda x: (0.01 * rng.standard_normal(x.shape)).astype(np.float32),
                     np_state["opt"].m),
        jax.tree.map(lambda x: ((0.01 * (1 + np.abs(rng.standard_normal(x.shape)))) ** 2)
                     .astype(np.float32), np_state["opt"].v))
    tstate = state_from_jax(np_state, device="cpu")
    # seed 0's batch holds a tie (test_seed0_batch_holds_a_pool_tie)
    rng = np.random.default_rng(1)
    b = {"images": rng.standard_normal((1, 4, 28, 28, 1)).astype(np.float32),
         "labels": rng.integers(0, 10, (1, 4)).astype(np.int32)}
    assert min(pool_gaps(tstate["params"], t(b["images"][0]))) > POOL_GAP
    tstate, tm = trun.fns.train_step(tstate, {"images": t(b["images"]),
                                              "labels": t(b["labels"]).long()})
    jstate, jm = jrun.fns.train_step(jax.tree.map(lambda x: jnp.array(x), np_state),
                                     jax.tree.map(jnp.asarray, b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for got, want in zip(tree_flatten(tstate["params"])[0], jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_seed0_batch_holds_a_pool_tie():
    """The GSPMD test's batch at seed 0 puts two of c2's outputs in one
    pool window within about 2 f32 ulps of each other (on the CPU, torch's
    oneDNN convolutions round them the other way from f64): a batch no f32
    comparison of the gradients can hold."""
    jrun = j_build_run(JRunSpec(preset="lenet5", backend="gspmd", batch=4))
    params = state_from_jax(jax.tree.map(np.array, jrun.init()), device="cpu")["params"]
    images = np.random.default_rng(0).standard_normal((1, 4, 28, 28, 1)).astype(np.float32)
    c1, c2 = pool_gaps(params, t(images[0]))
    assert c1 > 2e-7 and c2 < 2e-7, (c1, c2)


def test_gspmd_baseline_with_rules_raises_as_the_reference():
    """With a rule the policy's own codec meets the exchange, which has
    none for top-k: both packages refuse."""
    spec = dict(preset="lenet5", backend="gspmd", compressor="topk", dense_pattern="^f1b$")
    with pytest.raises(NotImplementedError, match="no exchange kernel"):
        j_build_run(JRunSpec(**spec))
    with pytest.raises(NotImplementedError, match="no exchange kernel"):
        build_run(RunSpec(**spec), device="cpu")


def test_build_dist_train_compressor_argument():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dist import build_dist_train

    cfg = get_config("lenet5")
    sbc = build_dist_train(cfg, compressor="sbc", sparsity=0.01, device="cpu")
    dense = build_dist_train(cfg, compressor="qsgd", sparsity=0.01, device="cpu")
    assert {gl.mode for gl in sbc.channel.leaves} == {"sparse"}
    assert {gl.mode for gl in dense.channel.leaves} == {"dense"}
    assert dense.bits_per_client == 32 * LENET5_PARAMS


# --------------------------------------------------------------------- fed


def test_fed_topk_rounds_match_the_reference_bit_for_bit():
    spec = dict(LENET, compressor="topk", batch=4, clients=4, cohort=2, rounds=2, lr=0.0,
                cohort_tile=1, fast=True)
    _, jsched, _, tsched = paired(spec, residual=True)
    jlog, tlog = capture_uploads(jsched), capture_uploads(tsched)
    for r in range(2):
        jm, tm = jsched.step(r), tsched.step(r)
        assert tlog[r] == jlog[r], f"round {r}: uploads differ"
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    assert tsched.ledger.history() == jsched.ledger.history()
    trees_bits_equal(tsched.server.params, jsched.server.params, "params")
    trees_bits_equal(tsched.pool.export_state()["residual"],
                     jsched.pool.export_state()["residual"], "pool residual rows")


def test_fed_signsgd_aggregate_matches_the_reference_bit_for_bit():
    """Trained signSGD rounds: the uploads' sizes and the ledger equal the
    reference's; the port's server, fed the reference's uploads of each
    round, aggregates to the reference's params bit for bit."""
    spec = dict(LENET, compressor="signsgd", batch=4, clients=4, cohort=2, rounds=2,
                cohort_tile=1, fast=True)
    _, jsched, _, tsched = paired(spec, warm_adam=True)
    jlog, tlog = capture_uploads(jsched), capture_uploads(tsched)
    receive = tsched.server.receive

    def receive_the_references(uploads, round_idx):
        ref = dict(jlog[round_idx])
        assert [len(u.blob) for u in uploads] == [len(ref[u.client_id]) for u in uploads]
        return receive([u._replace(blob=ref[u.client_id]) for u in uploads], round_idx)

    tsched.server.receive = receive_the_references
    for r in range(2):
        jm, tm = jsched.step(r), tsched.step(r)
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5 if r == 0 else 1e-4)
        trees_bits_equal(tsched.server.params, jsched.server.params, f"round {r} params")
    assert tsched.ledger.history() == jsched.ledger.history()


# ------------------------------------------- chip_smoke.py phase 10a's pins


@pytest.fixture(scope="module")
def smoke():
    return load_chip_smoke()


@pytest.fixture(scope="module")
def lenet5_like():
    from repro.configs.base import get_config as jget
    from repro.models.model import build_model as jbuild

    shapes = jax.eval_shape(jbuild(jget("lenet5")).init, jax.random.PRNGKey(0))
    return {k: np.zeros(v.shape, np.float32) for k, v in shapes.items()}


@pytest.mark.parametrize("point", range(15))
def test_table2_pins_are_the_references(smoke, lenet5_like, point):
    """``chip_smoke.py`` phase 10a holds every point's Eq. 1 bits a client
    in rounds 1 and 2 to ``TABLE2_BITS``, and its ``f32_mean_xla``
    launches a round to ``table2_means``: the first equal the reference's
    channel (run eagerly, full-width LeNet5), the second the port's calls
    on the CPU, per leaf: one client's, times the smoke's four clients (the
    per-leaf path compresses client by client)."""
    from repro.core.api import make_compressor as j_make
    from repro.core.channel import LocalVmapChannel as JChannel
    from repro_torch.core import stages as core_stages
    from repro_torch.core.api import make_compressor as t_make
    from repro_torch.core.channel import LocalVmapChannel
    from repro_torch.kernels import topk as ktopk

    label, comp, delay, p = smoke.TABLE2[point]
    clients = smoke.TABLE2_CLIENTS
    jch = JChannel(compressor=j_make(comp), n_clients=1)
    tch = LocalVmapChannel(compressor=t_make(comp), n_clients=1)
    jlike = jax.tree.map(jnp.asarray, lenet5_like)
    tlike = {k: t(v) for k, v in lenet5_like.items()}
    jstate, tstate = jch.init_state(jlike, jax.random.PRNGKey(0)), tch.init_state(tlike)
    calls = []
    saved = {mod: mod.f32_mean_xla for mod in (ktopk, core_stages)}
    for mod, real in saved.items():
        mod.f32_mean_xla = lambda x, *a, real=real, **k: calls.append(1) or real(x, *a, **k)
    try:
        for r in range(smoke.TABLE2_ROUNDS):
            rng = np.random.default_rng(r)
            d = {k: (0.01 * rng.standard_normal((1,) + v.shape)).astype(np.float32)
                 for k, v in lenet5_like.items()}
            rates = jch.resolved(jlike).rates(p, r)
            jex = jch.round_exchange({k: jnp.asarray(v) for k, v in d.items()}, jstate, rates)
            calls.clear()
            tex = tch.round_exchange({k: t(v) for k, v in d.items()}, tstate,
                                     tch.resolved(tlike).rates(p, r))
            assert len(calls) * clients == smoke.table2_means(comp), (label, r, len(calls))
            want = smoke.table2_bits(comp, p)[r]
            assert float(jex.bits_per_client) == want, (label, r)
            assert float(tex.bits_per_client) == want, (label, r)
            jstate, tstate = jex.state, tex.state
    finally:
        for mod, real in saved.items():
            mod.f32_mean_xla = real
    assert (label, comp, delay, p) in smoke.TABLE2
