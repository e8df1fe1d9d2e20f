"""Per-leaf policy rules on the port's GSPMD backend against the JAX
package, on the CPU: ``dense_pattern`` and ``skip_pattern`` through
``policy_from_spec`` and the exact engine.

Both packages build their policy with their own ``policy_from_spec`` from
the same ``RunSpec`` fields, and their train step from it; LeNet5 runs at
``img_size=12`` from the same warm carried-across state and numpy batches
(``test_torch_slice.py`` says why warm).  Tolerances are the exact
engine's of ``test_torch_exact.py``: round-1 loss ``rtol=1e-5``, later
rounds ``1e-4``; every round selects the same positions in every sparse
leaf, sends the dense leaves' values (``rtol=1e-4``, as the parameters)
and nothing of a skipped leaf; the ledger's rows are equal; parameters
``rtol=1e-4``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs.base import get_config as j_get_config
from repro.launch.dist import build_dist_train as j_build_dist_train
from repro.optim.optimizers import AdamState as JAdamState
from repro.run.build import policy_from_spec as j_policy_from_spec
from repro.run.spec import RunSpec as JRunSpec
from repro_torch import kernels
from repro_torch.configs.base import get_config
from repro_torch.convert import state_from_jax
from repro_torch.launch.dist import build_dist_train
from repro_torch.run import RunSpec, build_run, policy_from_spec
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SLICE = dict(preset="lenet5", backend="gspmd", fast=True, flat_engine="exact",
             sparsity=0.01)
RULES = {
    "dense-biases": dict(dense_pattern=r"^f[12]b$"),
    "dense-and-skip": dict(dense_pattern=r"^f[12]b$", skip_pattern=r"^c1$"),
}


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def warm_state(jfns, seed=42):
    jstate = jfns.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    jstate["opt"] = JAdamState(
        jax.tree.map(lambda m: jnp.asarray(0.01 * rng.standard_normal(m.shape),
                                           jnp.float32), jstate["opt"].m),
        jax.tree.map(lambda v: jnp.asarray((0.01 * rng.standard_normal(v.shape)) ** 2,
                                           jnp.float32), jstate["opt"].v),
    )
    return jax.tree.map(np.asarray, jstate)


@pytest.mark.parametrize("rules", sorted(RULES))
def test_policy_from_spec_composes_as_the_reference(rules):
    jp = j_policy_from_spec(JRunSpec(**SLICE, **RULES[rules]))
    tp = policy_from_spec(RunSpec(**SLICE, **RULES[rules]))
    assert (tp.name, tp.fast) == (jp.name, jp.fast)
    assert [(r.pattern, r.codec) for r in tp.rules] == [(r.pattern, r.codec) for r in jp.rules]
    for path in ("c1", "c2", "f1", "f1b", "f2", "f2b"):
        assert tp.plan_for(path).codec.spec == jp.plan_for(path).codec.spec
    # without rules, the compressor with the fast flag, as in the reference
    jc, tc = j_policy_from_spec(JRunSpec(**SLICE)), policy_from_spec(RunSpec(**SLICE))
    assert (tc.name, tc.policy.fast, tc.codec.spec) == (jc.name, jc.policy.fast, jc.codec.spec)


@pytest.mark.parametrize("device_pack", [False, True], ids=["host-metered", "device-pack"])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_three_exact_rounds_with_rules_match_jax(rules, device_pack):
    jpol = j_policy_from_spec(JRunSpec(**SLICE, **RULES[rules]))
    tpol = policy_from_spec(RunSpec(**SLICE, **RULES[rules]))
    jfns = j_build_dist_train(
        dataclasses.replace(j_get_config("lenet5"), img_size=12), one_device_mesh(),
        compressor="sbc", sparsity=0.01, policy=jpol, fast=True, flat_engine="exact",
        measure=True, device_pack=device_pack)
    tfns = build_dist_train(dataclasses.replace(get_config("lenet5"), img_size=12),
                            sparsity=0.01, policy=tpol, fast=True, flat_engine="exact",
                            measure=True, device_pack=device_pack, device="cpu")
    modes = {gl.path: gl.mode for gl in tfns.channel.leaves}
    assert modes == {gl.path: gl.mode for gl in jfns.channel.leaves}
    assert tfns.bits_per_client == jfns.bits_per_client
    assert tfns.bits_dense == jfns.bits_dense
    np_state = warm_state(jfns)
    jstate = jax.tree.map(jnp.asarray, np_state)
    tstate = state_from_jax(np_state, device="cpu")
    rng = np.random.default_rng(0)
    for r in range(3):
        b = {"images": rng.standard_normal((1, 16, 12, 12, 1)).astype(np.float32),
             "labels": rng.integers(0, 10, (1, 16)).astype(np.int32)}
        jstate, jm = jfns.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tfns.train_step(tstate, {"images": t(b["images"]),
                                              "labels": t(b["labels"]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4, err_msg=f"round {r + 1}")
        for key, want in jm["own_client0"].items():
            got = n(tm["own_client0"][key])
            np.testing.assert_array_equal(got != 0, n(want) != 0, err_msg=f"{key} r{r + 1}")
            if modes[key] == "dense":  # the values themselves, as the parameters
                np.testing.assert_allclose(got, n(want), rtol=1e-4, atol=1e-6)
            if modes[key] == "skip":
                assert not got.any()
        if device_pack:
            np.testing.assert_array_equal(n(tm["packed_words_client0"]),
                                          n(jm["packed_words_client0"]))
            np.testing.assert_array_equal(n(tm["packed_nbits"]), n(jm["packed_nbits"]))
        jfns.channel.record_round(r, own_client0=jm.get("own_client0"),
                                  packed_nbits=jm.get("packed_nbits"))
        tfns.channel.record_round(r, own_client0=tm.get("own_client0"),
                                  packed_nbits=tm.get("packed_nbits"))
    assert tfns.channel.ledger.history() == jfns.channel.ledger.history()
    for k, v in tstate["params"].items():
        np.testing.assert_allclose(n(v), n(jstate["params"][k]), rtol=1e-4, atol=1e-6)
    # the skipped leaf's update stays in the residual, whole
    if "skip_pattern" in RULES[rules]:
        res = tfns.residual_to_tree(tstate["residual"])["c1"]
        assert n(res).any()


def test_full_width_exact_run_with_dense_biases_on_the_cpu():
    """``--dense-pattern '^f[12]b$'`` through ``build_run`` at LeNet5's full
    width: the reference's Eq. 1 bits (four SBC leaves and 510 dense
    entries), finite losses, a ledger row a round, no kernel launch."""
    spec = dict(**SLICE, dense_pattern=r"^f[12]b$", measure_wire=True, device_pack=True)
    jfns = j_build_dist_train(j_get_config("lenet5"), one_device_mesh(), compressor="sbc",
                              sparsity=0.01, policy=j_policy_from_spec(JRunSpec(**spec)),
                              fast=True, flat_engine="exact")
    run = build_run(RunSpec(**spec, batch=8, rounds=2), device="cpu")
    kernels.reset_launches()
    state, hist = run.run()
    assert all(np.isfinite(hist["loss"])) and len(run.ledger.records) == 2
    assert run.fns.bits_per_client == jfns.bits_per_client
    assert set(kernels.launch_counts().values()) == {0}
    dense = sum(s.global_size for s in run.fns.flat_space.segments if s.kind == "dense")
    assert dense == 510
    for rec in run.ledger.records:
        assert rec.up_bits_analytic == jfns.bits_per_client


def test_hist_engine_refuses_dense_leaves_as_the_reference():
    run = build_run(RunSpec(**{**SLICE, "flat_engine": "hist"}, dense_pattern="b$", batch=8,
                            rounds=1), device="cpu")
    with pytest.raises(ValueError, match="all-SBC"):
        run.run()
