"""The port's deprecation shims against the JAX package's, on the CPU
(mirrors ``tests/test_legacy_api.py``): every legacy entry point warns
once with a ``DeprecationWarning`` and gives what its replacement gives.

  * ``make_dist_train`` warns and equals ``build_dist_train``;
  * ``DSGDTrainer`` warns and equals ``build_run(RunSpec(backend="local"))``
    bit for bit (params and residuals), at ``fast`` None and True;
  * its ``fast`` and ``residual_dtype`` fields are the reference's: for
    ``fast`` None, True and False and for a bf16 residual, one round of
    the port's trainer against the reference's on the same numpy params
    and batches.  Across the frameworks the forward and backward differ
    in their last ulps, so the loss is held to ``rtol=1e-5``, params to
    ``rtol=1e-5, atol=1e-7`` and each residual leaf to ``1e-4`` of its
    largest entry (bf16: ``2⁻⁸`` of it, one bf16 ulp there); Eq. 1 bits
    and the residual's layout and dtype are equal.
    A bf16 residual takes the per-leaf path even with ``fast=True`` (the
    flat residual is f32), in both packages.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core.api import make_compressor as j_make_compressor
from repro.optim import get_optimizer as j_get_optimizer
from repro.run.build import lr_schedule as j_lr_schedule
from repro.run.presets import build_preset as j_build_preset
from repro.train import DSGDTrainer as JTrainer
from repro_torch.convert import params_from_jax
from repro_torch.core import make_compressor
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.run import RunSpec, build_run, build_preset
from repro_torch.run.build import lr_schedule
from repro_torch.train import DSGDTrainer, TrainState
from torch_helpers import n, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

BATCH, SEQ, CLIENTS, P = 4, 16, 2, 0.05


def _no_deprecation(record) -> None:
    deps = [w for w in record if issubclass(w.category, DeprecationWarning)
            and "repro" in str(w.message)]
    assert not deps, f"replacement surface warned: {deps[0].message}"


def _leaves(tree):
    return tree_flatten(tree)[0]


def assert_trees_equal(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), what


# -------------------------------------------------- the bf16 mean over clients


@pytest.mark.parametrize("clients", [2, 3, 4, 5, 8])
def test_mean_over_clients_of_bf16_is_jnp_means(clients):
    """A bf16 residual's ΔW* rows are averaged as ``jnp.mean`` averages
    bf16 under ``jit``: summed and scaled in f32, rounded once."""
    from repro_torch.core.channel import mean_over_clients

    rng = np.random.default_rng(clients)
    d = (rng.standard_normal((clients, 20000)) * np.exp(rng.standard_normal((clients, 20000)))
         ).astype(np.float32)
    d[:, :40] = 0.0
    want = jax.jit(lambda x: jnp.mean(x, axis=0))(jnp.asarray(d).astype(jnp.bfloat16))
    got = mean_over_clients(torch.from_numpy(d).to(torch.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


# ------------------------------------------------------------ make_dist_train


def test_make_dist_train_warns_and_is_build_dist_train():
    from repro_torch.launch.dist import build_dist_train, make_dist_train

    cfg, _ = build_preset("tiny", batch=BATCH, seq_len=SEQ, device="cpu")
    with pytest.warns(DeprecationWarning, match="build_dist_train"):
        legacy = make_dist_train(cfg, sparsity=P, device="cpu")
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        new = build_dist_train(cfg, sparsity=P, device="cpu")
    _no_deprecation(record)
    assert legacy.bits_per_client == new.bits_per_client
    assert legacy.bits_dense == new.bits_dense
    assert list(legacy.channel.leaves) == list(new.channel.leaves)


# -------------------------------------------------------------- DSGDTrainer


@pytest.mark.parametrize("fast", [None, True], ids=["fast-none", "fast"])
def test_trainer_warns_and_is_build_run(fast):
    from repro_torch.data import client_batches

    spec = RunSpec(preset="tiny", backend="local", rounds=1, batch=BATCH, seq_len=SEQ,
                   clients=CLIENTS, delay=1, sparsity=P, fast=bool(fast))
    cfg, task = build_preset("tiny", batch=BATCH, seq_len=SEQ, device="cpu")
    with pytest.warns(DeprecationWarning, match="build_run"):
        trainer = DSGDTrainer(model=build_model(cfg), compressor=make_compressor("sbc"),
                              optimizer=get_optimizer(cfg.local_opt), n_clients=CLIENTS,
                              lr=lr_schedule(cfg.base_lr), fast=fast, device="cpu")
    legacy, _ = trainer.fit(None, client_batches(task, CLIENTS, 1), n_rounds=1, n_delay=1,
                            sparsity=P)
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        run = build_run(spec, device="cpu")
    _no_deprecation(record)
    state, _ = run.run()
    assert_trees_equal(state.params, legacy.params, "params")
    assert_trees_equal(state.comp_state.residual, legacy.comp_state.residual, "residuals")
    flat = isinstance(legacy.comp_state.residual, torch.Tensor)
    assert flat == bool(fast)


# ------------------------------------------ fast and residual_dtype, by field


CASES = {"fast-none": dict(fast=None), "fast": dict(fast=True), "per-leaf": dict(fast=False),
         "bf16": dict(fast=True, residual_dtype="bfloat16")}


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny decoder, its initial params and one round's
    batches ``(clients, 1, batch, seq)``, drawn once."""
    from repro.data import client_batches as j_client_batches
    from repro.models.model import build_model as j_build_model

    cfg, task = j_build_preset("tiny", batch=BATCH, seq_len=SEQ)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = j_client_batches(task, CLIENTS, 1)(0)
    return cfg, model, params, batch


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_fields_are_the_references(case, tiny):
    cfg, jmodel, jparams, jbatch = tiny
    kw = dict(CASES[case])
    dtype = kw.pop("residual_dtype", None)
    jkw = dict(kw, **({"residual_dtype": jnp.bfloat16} if dtype else {}))
    tkw = dict(kw, **({"residual_dtype": torch.bfloat16} if dtype else {}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jtr = JTrainer(model=jmodel, compressor=j_make_compressor("sbc"),
                       optimizer=j_get_optimizer(cfg.local_opt), n_clients=CLIENTS,
                       lr=j_lr_schedule(cfg.base_lr), **jkw)
        tcfg, _ = build_preset("tiny", batch=BATCH, seq_len=SEQ, device="cpu")
        ttr = DSGDTrainer(model=build_model(tcfg), compressor=make_compressor("sbc"),
                          optimizer=get_optimizer(tcfg.local_opt), n_clients=CLIENTS,
                          lr=lr_schedule(tcfg.base_lr), device="cpu", **tkw)
    jstate = jtr.init(jax.random.PRNGKey(0))._replace(params=jparams)
    jstate = jstate._replace(comp_state=jtr.channel.init_state(jparams, jax.random.PRNGKey(1)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    topt = ttr.optimizer.init(tparams)
    tstate = TrainState(tparams, tree_map(lambda v: v.expand((CLIENTS,) + tuple(v.shape))
                                          .clone(), topt) if topt != () else (),
                        ttr.channel.init_state(tparams), torch.zeros((), dtype=torch.int32))
    tbatch = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in jbatch.items()}

    jstate, jm = jtr.round_step(jstate, jbatch, n_delay=1, sparsity=P)
    tstate, tm = ttr.round_step(tstate, tbatch, n_delay=1, sparsity=P)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["bits_per_client"]), float(jm["bits_per_client"]),
                               rtol=2 ** -23)
    for a, b in zip(_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-7)
    jres = jstate.comp_state.residual
    tres = tstate.comp_state.residual
    flat = kw.get("fast") is True and not dtype
    assert isinstance(tres, torch.Tensor) == flat
    assert isinstance(jres, jax.Array) == flat
    jl, tl = jax.tree.leaves(jres), _leaves(tres)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for a, b in zip(tl, jl):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        want = np.asarray(b, np.float32)
        np.testing.assert_allclose(n(a.to(torch.float32)), want, rtol=0,
                                   atol=(2 ** -8 if dtype else 1e-4) * np.abs(want).max())
