"""LeNet5, its loss and the client optimizers: the port against the JAX
package, from the same carried-across parameters and numpy batches.

Tolerances:
  * loss and gradients: ``rtol=1e-5, atol=1e-6`` (f32 convolutions and
    matrix products accumulate in another order in XLA and in torch);
  * optimizer steps are elementwise f32 arithmetic; XLA may fuse a
    multiply-add where torch rounds twice, so values are held to
    ``rtol=1e-6`` (one or two ulps), and masks are bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.synthetic import make_classification_task as j_task
from repro.models.losses import softmax_xent as j_softmax_xent
from repro.models.model import build_model as j_build_model
from repro.optim.optimizers import get_optimizer as j_get_optimizer
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import make_classification_task
from repro_torch.models.losses import softmax_xent
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import AdamState, get_optimizer
from torch_helpers import n, t


def batch(img_size, b, seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, img_size, img_size, 1)).astype(np.float32),
            "labels": rng.integers(0, 10, (b,)).astype(np.int32)}


@pytest.mark.parametrize("img_size", [28, 12])
def test_loss_and_grads_match_jax(img_size):
    jcfg = dataclasses.replace(j_get_config("lenet5"), img_size=img_size)
    tcfg = dataclasses.replace(get_config("lenet5"), img_size=img_size)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(img_size))
    # non-zero biases, so a bias added to the wrong axis would show
    jparams = {k: (v + 0.05 if k.endswith("b") else v) for k, v in jparams.items()}
    bt = batch(img_size, 8, seed=img_size)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in bt.items()})

    params = {k: p.requires_grad_(True) for k, p in
              params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu").items()}
    loss = tmodel.loss_fn(params, {"images": t(bt["images"]),
                                   "labels": t(bt["labels"]).long()})
    keys = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k, g in zip(keys, grads):
        assert tuple(g.shape) == jgrads[k].shape
        np.testing.assert_allclose(n(g), n(jgrads[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_init_shapes_and_scales_match_jax():
    jparams = j_build_model(j_get_config("lenet5")).init(jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(get_config("lenet5")).init(gen)
    assert sorted(params) == sorted(jparams)
    assert sum(v.numel() for v in params.values()) == 1_256_010
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape and v.dtype == torch.float32
        np.testing.assert_allclose(float(v.std()), float(jnp.std(jparams[k])),
                                   rtol=0.1, atol=1e-12, err_msg=k)


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 6, 11)) * 5).astype(np.float32)
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    want = float(j_softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(softmax_xent(t(logits), t(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _tree(rng, shapes, scale=1.0, positive=False):
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
    return {k: v * v for k, v in out.items()} if positive else out


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("step", [0, 7])
def test_optimizer_apply_and_mask_match_jax(name, step):
    rng = np.random.default_rng(1)
    shapes = {"a": (40, 30), "b": (30,)}
    params, grads = _tree(rng, shapes), _tree(rng, shapes, 0.1)
    jopt, topt = j_get_optimizer(name), get_optimizer(name)
    if name == "adam":
        m, v = _tree(rng, shapes, 0.01), _tree(rng, shapes, 0.01, positive=True)
        jstate = type(jopt.init(params))(m, v)
        tstate = AdamState({k: t(x) for k, x in m.items()}, {k: t(x) for k, x in v.items()})
    elif name == "momentum":
        m = _tree(rng, shapes, 0.01)
        jstate, tstate = m, {k: t(x) for k, x in m.items()}
    else:
        jstate, tstate = (), ()
    jp, js = jopt.apply(jstate, grads, params, 1e-3, jnp.asarray(step, jnp.int32))
    tp, ts = topt.apply(tstate, {k: t(x) for k, x in grads.items()},
                        {k: t(x) for k, x in params.items()}, 1e-3, step)
    for k in shapes:
        np.testing.assert_allclose(n(tp[k]), n(jp[k]), rtol=1e-6, err_msg=k)
    for jl, tl in zip(jax.tree.leaves(js), _leaves(ts), strict=True):
        np.testing.assert_allclose(n(tl), n(jl), rtol=1e-6)

    transmitted = {k: (rng.uniform(size=s) < 0.3).astype(np.float32) for k, s in shapes.items()}
    jm = jopt.mask(js, transmitted)
    tm = topt.mask(ts, {k: t(x) for k, x in transmitted.items()})
    for jl, tl in zip(jax.tree.leaves(jm), _leaves(tm), strict=True):
        np.testing.assert_allclose(n(tl), n(jl), rtol=1e-6)
    # masking zeroes momentum (Adam's m) exactly where transmitted
    if name != "sgd":
        m_before, m_after = (ts.m, tm.m) if name == "adam" else (ts, tm)
        for k in shapes:
            np.testing.assert_array_equal(n(m_after[k]),
                                          n(m_before[k]) * (1 - transmitted[k]))


def _leaves(state):
    """The port's optimizer state in JAX's tree-flatten order."""
    if isinstance(state, AdamState):
        return [state.m[k] for k in sorted(state.m)] + [state.v[k] for k in sorted(state.v)]
    return [state[k] for k in sorted(state)] if state else []


def test_blob_task_is_deterministic_per_step_and_client():
    task = make_classification_task(n_classes=10, img_size=28, channels=1, batch=6,
                                    device="cpu")
    a, b = task.sample(3, 0), task.sample(3, 0)
    assert tuple(a["images"].shape) == (6, 28, 28, 1) and a["images"].dtype == torch.float32
    assert tuple(a["labels"].shape) == (6,) and int(a["labels"].max()) < 10
    assert torch.equal(a["images"], b["images"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["images"], task.sample(3, 1)["images"])
    assert not torch.equal(a["images"], task.sample(4, 0)["images"])
    # same distribution as the reference: class means of scale 0.5, noise 0.35
    jt = j_task(n_classes=10, img_size=28, channels=1, batch=256)
    tt = make_classification_task(n_classes=10, img_size=28, channels=1, batch=256,
                                  device="cpu")
    np.testing.assert_allclose(float(tt.sample(0, 0)["images"].std()),
                               float(jnp.std(jt.sample(0, 0)["images"])), rtol=0.05)
