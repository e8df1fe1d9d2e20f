"""The port's ResNet-32 (``repro_torch.models.cnn``, paper §IV-A) against
the JAX package's, on the CPU: its tree, its layers, its loss and
gradients at full width, and one GSPMD round of each flat engine through
``build_dist_train``.

Inputs are made with numpy from a seed and handed to both packages; the
reference's parameters are carried across.

Tolerances:
  * the tree (97 leaves, 466,714 parameters), paths and shapes: equal;
  * ``conv``: a 1 x 1 convolution of one input channel is a product an
    entry, bit for bit in both; the others sum in another order, so
    ``rtol=1e-5, atol=1e-6``.  XLA's SAME padding at stride 2 is
    asymmetric (0 before, 1 after on 32- and 16-wide maps), and torch's
    symmetric ``padding=1`` is checked to give a different output;
  * ``batchnorm`` (population variance over N, H, W, summed in another
    order): ``rtol=1e-5, atol=1e-5``;
  * the loss at full width, batch 2: ``rtol=1e-5``; each leaf's gradient
    to ``atol=2e-4`` of that leaf's largest entry (seen: 1.1e-5), since
    a BN gradient is a difference of sums over the batch;
  * the momentum optimizer as the GSPMD backend builds it
    (``state_dtype=cfg.residual_dtype``, f32 and bf16), apply and mask:
    bit for bit;
  * one GSPMD round (momentum at lr 0.01, p = 0.01): Eq. 1 bits a client
    equal (41,267.93), the loss to ``rtol=1e-5``, the params and the
    momentum to ``rtol=1e-4, atol=1e-5``: a segment of 16 BN entries sends
    its one largest ΔW = −0.01·g as μ, and a BN gradient at batch 2 is a
    difference of batch sums that the frameworks round apart (seen: 2.1e-6
    on a param, 3e-4 of its update);
  * the port's f32 loss and gradients at full width, batch 16, against
    f64: within ``chip_smoke.py``'s ``RESNET32_F64_TOL`` (loss 1e-6
    relative, gradients 5e-3 in norm), and a TF32 rounding of every
    convolution outside it, as the card's check holds cuDNN;
  * ``preset="resnet32"``: the reference's error class (``ValueError``).
    The reference builds an LM task of vocabulary 0 for it and fails at
    the first batch it draws; the port refuses when it builds the
    preset.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import get_config as j_get_config
from repro.launch.dist import build_dist_train as j_build_dist_train
from repro.models import cnn as jcnn
from repro.models.model import build_model as j_build_model
from repro.optim.optimizers import get_optimizer as j_get_optimizer
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro_torch.configs.base import PAPER_ARCHS, get_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
from repro_torch.launch.dist import build_dist_train
from repro_torch.models import cnn
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.run import RunSpec, build_run
from torch_helpers import load_chip_smoke, n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

PARAMS, LEAVES = 466_714, 97
EQ1_BITS = 41_267.933283016355  # the reference's Eq. 1 bits a client at p = 0.01


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, j_build_model(j_get_config("resnet32")).init(
        jax.random.PRNGKey(0)))


def images(batch, size=32, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((batch, size, size, channels)).astype(np.float32),
            "labels": rng.integers(0, 10, (batch,)).astype(np.int32)}


def test_config_and_tree_are_the_reference(jparams):
    cfg, jcfg = get_config("resnet32"), j_get_config("resnet32")
    for f in dataclasses.fields(cfg):
        if f.name not in ("dtype", "residual_dtype"):  # each framework's own dtypes
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.float32 and jnp.dtype(jcfg.dtype).name == "float32"
    assert "resnet32" in PAPER_ARCHS
    tree = build_model(cfg).init(torch.Generator().manual_seed(0))
    got = [(path_str(p), tuple(v.shape)) for p, v in tree_flatten_with_path(tree)[0]]
    want = [(path_str(p), v.shape) for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert got == want
    assert len(got) == LEAVES and sum(v.numel() for v in tree_flatten(tree)[0]) == PARAMS
    assert sum(np.prod(s) < 1024 for _, s in got) == 66
    # He-normal scales: each kernel's std within 10% of the reference's
    for (path, _), a, b in zip(got, tree_flatten(tree)[0], jax.tree.leaves(jparams)):
        if a.numel() >= 1000:
            np.testing.assert_allclose(float(a.std()), float(np.std(b)), rtol=0.1, err_msg=path)


@pytest.mark.parametrize("k, cin, cout, stride, size", [
    (3, 16, 32, 2, 32), (3, 32, 64, 2, 16), (1, 16, 32, 2, 32), (3, 3, 16, 1, 32),
    (3, 16, 16, 1, 8), (1, 1, 4, 2, 9), (3, 4, 4, 2, 7)])
def test_conv_is_xla_same_padding(k, cin, cout, stride, size):
    rng = np.random.default_rng(k * 100 + cin + stride)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(w), jnp.asarray(x), stride))
    got = n(cnn.conv(t(w), t(x).permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1))
    assert got.shape == want.shape
    if k == 1 and cin == 1:  # one product an entry: bit for bit
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if k == 3 and stride == 2 and size % 2 == 0:
        assert cnn._same_pads(size, k, stride) == (0, 1)
        sym = torch.nn.functional.conv2d(t(x).permute(0, 3, 1, 2), t(w).permute(3, 2, 0, 1),
                                         stride=stride, padding=1)
        assert not np.allclose(n(sym.permute(0, 2, 3, 1)), want, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 32, 32, 16), (4, 8, 8, 64), (1, 3, 5, 2)])
def test_batchnorm_is_the_reference(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    want = np.asarray(jcnn.batchnorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = n(cnn.batchnorm({k: t(v) for k, v in p.items()},
                          t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_full_width_loss_and_gradients(jparams):
    b = images(2)
    jmodel = j_build_model(j_get_config("resnet32"))
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, b))
    leaves, treedef = tree_flatten(params_from_jax(jparams, "cpu"))
    leaves = [v.requires_grad_(True) for v in leaves]
    loss = build_model(get_config("resnet32")).loss_fn(
        treedef.unflatten(leaves), {"images": t(b["images"]), "labels": t(b["labels"]).long()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for (path, _), g, want in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], grads,
                                  jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(n(g), want, rtol=0,
                                   atol=2e-4 * float(np.abs(want).max()) + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def test_f32_gradients_against_f64_and_a_tf32_control():
    """``chip_smoke.py`` holds one ResNet-32 forward and gradient on the
    card against f64 to ``RESNET32_F64_TOL``, with cuDNN's TF32 as the
    control that must miss it.  The same here at full width, batch 16:
    the port's f32 loss and gradients within the tolerance, and the same
    f32 computation with every convolution's operands and output
    gradient rounded to TF32's 10 mantissa bits outside it."""
    import torch.nn.functional as F

    tol = load_chip_smoke().RESNET32_F64_TOL
    cfg = get_config("resnet32")
    model = build_model(cfg)
    leaves, treedef = tree_flatten(model.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    b = {"images": t(rng.standard_normal((16, 32, 32, 3)).astype(np.float32)),
         "labels": t(rng.integers(0, 10, (16,)).astype(np.int64))}

    ls = [v.double().requires_grad_(True) for v in leaves]
    logits = cnn.resnet32_apply(treedef.unflatten(ls), b["images"].double(), cfg)
    loss64 = torch.mean(torch.logsumexp(logits, -1)
                        - logits.gather(-1, b["labels"][:, None])[:, 0])
    grads64 = torch.autograd.grad(loss64, ls)
    norm64 = torch.sqrt(sum(torch.sum(g * g) for g in grads64))

    def errors():
        ls = [v.detach().requires_grad_(True) for v in leaves]
        loss = model.loss_fn(treedef.unflatten(ls), b)
        grads = torch.autograd.grad(loss, ls)
        diff = torch.sqrt(sum(torch.sum((g.double() - w) ** 2) for g, w in zip(grads, grads64)))
        return (abs(float(loss.detach()) - float(loss64.detach())) / float(loss64.detach()),
                float(diff / norm64))

    def to_tf32(x):  # round to nearest on 10 mantissa bits
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    class RoundTF32(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return to_tf32(x)

        @staticmethod
        def backward(ctx, g):
            return to_tf32(g)

    full = errors()
    conv2d = F.conv2d
    F.conv2d = lambda x, w, *a, **k: conv2d(RoundTF32.apply(x), RoundTF32.apply(w), *a, **k)
    try:
        tf32 = errors()
    finally:
        F.conv2d = conv2d
    assert full[0] <= tol["loss"] and full[1] <= tol["grads"], full
    assert tf32[0] > tol["loss"] or tf32[1] > tol["grads"], tf32


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_momentum_as_the_gspmd_backend_builds_it_is_bit_for_bit(jparams, state_dtype):
    rng = np.random.default_rng(3)
    jdt, tdt = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    jopt = j_get_optimizer("momentum", state_dtype=jdt)
    topt = get_optimizer("momentum", state_dtype=tdt)
    grads = jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
                         jparams)
    m0 = jax.tree.map(lambda x: np.asarray(jnp.asarray(
        0.01 * rng.standard_normal(x.shape), jdt).astype(jnp.float32)), jparams)
    jstate = jax.tree.map(lambda x: jnp.asarray(x, jdt), m0)
    tstate = jax.tree.map(lambda x: t(x).to(tdt), m0)
    jp, js = jopt.apply(jstate, jax.tree.map(jnp.asarray, grads),
                        jax.tree.map(jnp.asarray, jparams), 0.01, 0)
    tp, ts = topt.apply(tstate, params_from_jax(grads, "cpu"), params_from_jax(jparams, "cpu"),
                        0.01, 0)
    sent = jax.tree.map(lambda x: (rng.uniform(size=x.shape) < 0.01).astype(np.float32),
                        jparams)
    jm, tm = jopt.mask(js, sent), topt.mask(ts, params_from_jax(sent, "cpu"))
    for got, want in ((tp, jp), (ts, js), (tm, jm)):
        for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(n(a.float()), np.asarray(b, np.float32))


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("engine", ["hist", "exact"])
def test_one_gspmd_round_matches_the_reference(engine):
    jcfg, cfg = j_get_config("resnet32"), get_config("resnet32")
    jfns = j_build_dist_train(jcfg, one_device_mesh(), compressor="sbc", sparsity=0.01,
                              fast=True, flat_engine=engine)
    tfns = build_dist_train(cfg, compressor="sbc", sparsity=0.01, fast=True,
                            flat_engine=engine, device="cpu")
    assert tfns.bits_per_client == jfns.bits_per_client == EQ1_BITS
    assert tfns.bits_dense == jfns.bits_dense == 32 * PARAMS
    assert len(tfns.flat_space.segments) == LEAVES
    # numpy copies: the reference's step donates its state's buffers
    np_state = jax.tree.map(np.array, jfns.init_state(jax.random.PRNGKey(0)))
    b = images(2)
    b = {k: v[None] for k, v in b.items()}
    tstate, tm = tfns.train_step(state_from_jax(np_state, device="cpu"),
                                 {"images": t(b["images"]), "labels": t(b["labels"]).long()})
    jstate, jm = jfns.train_step(jax.tree.map(jnp.array, np_state),
                                 jax.tree.map(jnp.asarray, b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for got, want in zip(tree_flatten(tstate["params"])[0], jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    for got, want in zip(tree_flatten(tstate["opt"])[0], jax.tree.leaves(jstate["opt"])):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_resnet32_preset_raises_the_reference_error_class():
    spec = dict(preset="resnet32", backend="local", rounds=1, batch=2)
    with pytest.raises(ValueError):
        j_build_run(JRunSpec(**spec)).run()
    with pytest.raises(ValueError, match="vocabulary 0"):
        build_run(RunSpec(**spec), device="cpu")
