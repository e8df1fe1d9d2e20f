"""The paper's WordLSTM (§IV-A: Zaremba et al.'s "medium" 2 x 650 LSTM
over a 10,000-word vocabulary) in the port against the JAX package, on
the CPU: its config and ``reduced``, its full-width forward and loss,
and the ``wordlstm`` preset (the reference's reduced config on the
markov LM task) on the local and GSPMD backends.

Inputs are made with numpy from a seed and handed to both packages; the
reference's parameters are carried across.

Tolerances:
  * configs, ``reduced`` and the tree: equal; the preset's markov table
    is each package's own draw, so its entropy floor within 10%, as
    ``tests/test_torch_lm_task.py`` holds CharLSTM's;
  * the full-width loss at batch 2 x 8: ``rtol=1e-5``; the logits
    ``rtol=1e-4, atol=1e-5`` (650-long dot products summed in another
    order);
  * the preset's runs, as ``tests/test_torch_charlstm_run.py`` holds
    CharLSTM's (SGD at lr 1.0): the loss ``rtol=1e-5`` in round 1 and
    ``1e-4`` after; Eq. 1 bits equal (within one f32 ulp on the
    reference's jitted fast path); the params within ``rtol=1e-4,
    atol=1e-6`` but at most two entries per client, SBC segment and round
    (a k-th/(k+1)-th swap); measured bits within 0.1%.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models.model import build_model as j_build_model
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro.run.presets import build_preset as j_build_preset
from repro_torch.configs.base import PAPER_ARCHS, get_config, reduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
from repro_torch.models import lstm
from repro_torch.models.model import build_model
from repro_torch.run import RunSpec, build_run
from repro_torch.run.presets import build_preset
from repro_torch.train import TrainState
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

P = 0.01
PARAMS = 19_765_200
VOCAB = 512  # the reduced preset's
LOCAL = dict(preset="wordlstm", backend="local", clients=2, delay=2, batch=2, seq_len=8,
             sparsity=P, rounds=2, measure_wire=True)
GSPMD = dict(preset="wordlstm", backend="gspmd", fast=True, batch=2, seq_len=8, sparsity=P,
             rounds=2, measure_wire=True)
# the port's config carries every field of the reference's (since the
# decoder zoo's part 2); the dtypes are each framework's own
DTYPE_FIELDS = {"dtype", "residual_dtype"}


def carried(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in DTYPE_FIELDS}


@pytest.mark.parametrize("name", ["lenet5", "resnet32", "charlstm", "wordlstm"])
def test_config_and_reduced_are_the_reference(name):
    assert name in PAPER_ARCHS
    cfg, jcfg = get_config(name), j_get_config(name)
    for full, ref in ((cfg, jcfg), (reduced(cfg), j_reduced(jcfg))):
        for k, v in carried(full).items():
            assert getattr(ref, k) == v, (name, k)
        for k in DTYPE_FIELDS:
            assert str(getattr(full, k)) == "torch." + jnp.dtype(getattr(ref, k)).name
    port_fields = set(carried(cfg)) | DTYPE_FIELDS
    ref_fields = {f.name for f in dataclasses.fields(jcfg)}
    assert port_fields == ref_fields
    assert reduced(cfg, n_layers=1).n_layers == 1


def test_full_width_tree_forward_and_loss():
    jcfg, cfg = j_get_config("wordlstm"), get_config("wordlstm")
    jparams = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, "cpu")
    mine = build_model(cfg).init(torch.Generator().manual_seed(0))
    got = [(path_str(p), tuple(v.shape)) for p, v in tree_flatten_with_path(mine)[0]]
    want = [(path_str(p), v.shape) for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert got == want and len(got) == 8
    assert sum(v.numel() for v in tree_flatten(mine)[0]) == PARAMS
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 10_000, (2, 9)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jlogits = np.asarray(jax.jit(lambda p, x: __import__("repro.models.lstm", fromlist=["x"])
                                 .lstm_lm_apply(p, x, jcfg))(jparams, jnp.asarray(b["tokens"])))
    tlogits = n(lstm.lstm_lm_apply(tparams, t(b["tokens"]).long(), cfg))
    assert tlogits.shape == (2, 8, 10_000)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    jloss = j_build_model(jcfg).loss_fn(jax.tree.map(jnp.asarray, jparams),
                                        jax.tree.map(jnp.asarray, b))
    tloss = build_model(cfg).loss_fn(tparams, {k: t(v).long() for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_preset_is_the_reference_generic_arm():
    cfg, task = build_preset("wordlstm", batch=3, seq_len=5, device="cpu")
    jcfg, jtask = j_build_preset("wordlstm", batch=3, seq_len=5)
    for k, v in carried(cfg).items():
        assert getattr(jcfg, k) == v, k
    assert (cfg.vocab_size, cfg.lstm_hidden, cfg.n_layers) == (VOCAB, 64, 2)
    b = task.sample(0, 0)
    assert tuple(b["tokens"].shape) == (3, 5) and int(b["tokens"].max()) < VOCAB
    assert task.vocab_size == jtask.vocab_size == VOCAB
    # the markov table is drawn by each package's own generator (torch cannot
    # draw threefry bits), so its floor is held as tests/test_torch_lm_task.py
    # holds CharLSTM's: within 10% of the reference's, below ln V
    assert abs(task.entropy_floor - jtask.entropy_floor) < 0.1 * jtask.entropy_floor
    assert 0.0 < task.entropy_floor < np.log(VOCAB)


# --------------------------------------------------------------------- runs


def lm_batches(lead, rounds, seed=0, batch=2, seq_len=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        toks = rng.integers(0, VOCAB, lead + (batch, seq_len + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def t_batch(b):
    return {k: t(v).long() for k, v in b.items()}


def assert_params_close(got_tree, want_tree, swaps: int) -> None:
    off = 0
    for want, got in zip(jax.tree.leaves(want_tree), tree_flatten(got_tree)[0]):
        off += int((~np.isclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-6)).sum())
    assert off <= swaps, f"{off} entries off the reference's, more than {swaps} swaps allow"


def assert_ledgers_close(trun, jrun, fast: bool) -> None:
    th, jh = trun.ledger.history(), jrun.ledger.history()
    for a, b in zip(th.pop("up_bits_measured"), jh.pop("up_bits_measured")):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    np.testing.assert_allclose(th.pop("up_bits_analytic"), jh.pop("up_bits_analytic"),
                               rtol=2 ** -23 if fast else 0)
    th.pop("up_bytes"), jh.pop("up_bytes")
    assert th == jh


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_local_preset_runs_match_the_reference(fast):
    jrun = j_build_run(JRunSpec(**LOCAL, fast=fast))
    trun = build_run(RunSpec(**LOCAL, fast=fast), device="cpu")
    jstate = jrun.init()
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu")
    tstate = TrainState(params, (), trun.trainer.channel.init_state(params),
                        torch.zeros((), dtype=torch.int32))
    data = lm_batches((2, 2), 2)
    jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data[r])
    trun.batch_fn = lambda r: t_batch(data[r])
    for r in range(2):
        jstate, jm = jrun.step(jstate, r)
        tstate, tm = trun.step(tstate, r)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4)
        np.testing.assert_allclose(float(tm["bits_per_client"]), float(jm["bits_per_client"]),
                                   rtol=2 ** -23 if fast else 0)
    assert_ledgers_close(trun, jrun, fast)
    assert_params_close(tstate.params, jstate.params, swaps=2 * 2 * 8 * 2)


@pytest.mark.parametrize("engine", ["hist", "exact"])
def test_gspmd_preset_runs_match_the_reference(engine):
    extra = dict(flat_engine=engine, device_pack=engine == "exact")
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jrun = j_build_run(JRunSpec(**GSPMD, **extra), mesh=mesh)
    trun = build_run(RunSpec(**GSPMD, **extra), device="cpu")
    assert trun.fns.bits_per_client == jrun.fns.bits_per_client
    np_state = jax.tree.map(np.array, jrun.init())
    jstate, tstate = jax.tree.map(jnp.array, np_state), state_from_jax(np_state, "cpu")
    data = lm_batches((1,), 2, seed=1)
    jrun._batch = lambda r: jax.tree.map(jnp.asarray, data[r])
    trun._batch = lambda r: t_batch(data[r])
    for r in range(2):
        jstate, jm = jrun.step(jstate, r)
        tstate, tm = trun.step(tstate, r)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4)
    assert_params_close(tstate["params"], jstate["params"], swaps=2 * 8 * 2)
    assert_ledgers_close(trun, jrun, False)
