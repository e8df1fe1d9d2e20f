"""The port's CharLSTM (``repro_torch.models.lstm``) and the tree-generic
parts it needs, against the JAX package, on the CPU.

The model runs at a small width (``lstm_hidden=32``, the paper's two
layers and 98-token vocabulary, batch 2, 8 steps); its parameters are
the reference's, carried across with the nested ``params_from_jax``.
Tolerances (forward and backward differ between the frameworks in the
order of a GEMM's adds only):
  * ``lstm_cell``'s ``(h, c)``, ``lstm_lm_apply``'s logits and the loss:
    ``rtol=1e-5`` (``atol=1e-6`` where a value can cross zero);
  * gradients (``jax.grad`` against autograd): ``rtol=1e-4`` beside
    ``atol`` of 1e-6 of the leaf's largest gradient; exact zeros (the
    embedding rows of tokens not in the batch) are exact in both.
The tree-generic parts (``tree_map``, the nested convert, the optimizers,
checkpoints) are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_pytree as j_load_pytree
from repro.checkpoint.io import save_pytree as j_save_pytree
from repro.configs.base import get_config as j_get_config
from repro.models import lstm as jlstm
from repro.models.model import build_model as j_build_model
from repro.optim.optimizers import get_optimizer as j_get_optimizer
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.models import lstm
from repro_torch.models.layers import embed_lookup, init_embed
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import AdamState, get_optimizer
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SMALL = dict(lstm_hidden=32)
B, S = 2, 8


@pytest.fixture(scope="module")
def small():
    """(reference cfg, port cfg, reference params (numpy), port params,
    tokens, labels) at lstm_hidden=32."""
    jcfg = dataclasses.replace(j_get_config("charlstm"), **SMALL)
    tcfg = dataclasses.replace(get_config("charlstm"), **SMALL)
    np_params = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 98, (B, S + 1)).astype(np.int32)
    return jcfg, tcfg, np_params, params_from_jax(np_params, "cpu"), toks[:, :-1], toks[:, 1:]


def _paths(tree):
    return [(path_str(p), tuple(np.shape(x))) for p, x in tree_flatten_with_path(tree)[0]]


def test_config_is_the_reference_preset():
    j, c = j_get_config("charlstm"), get_config("charlstm")
    for f in ("name", "family", "source", "n_layers", "vocab_size", "lstm_hidden",
              "local_opt", "base_lr", "client_mode", "img_size"):
        assert getattr(c, f) == getattr(j, f), f


def test_full_width_tree_is_the_references():
    """Eight leaves, 680,800 f32 parameters, the reference's paths and
    shapes in its flattening order."""
    j_shapes = jax.eval_shape(j_build_model(j_get_config("charlstm")).init,
                              jax.random.PRNGKey(0))
    j_rows = [(jax.tree_util.keystr(p, simple=True, separator="/"), tuple(x.shape))
              for p, x in jax.tree_util.tree_flatten_with_path(j_shapes)[0]]
    params = build_model(get_config("charlstm")).init(torch.Generator().manual_seed(0))
    assert _paths(params) == j_rows
    assert [p for p, _ in j_rows] == ["cell0/b", "cell0/wh", "cell0/wx", "cell1/b",
                                      "cell1/wh", "cell1/wx", "embed/embedding", "head/w"]
    leaves = tree_flatten(params)[0]
    assert sum(x.numel() for x in leaves) == 680_800
    assert all(x.dtype == torch.float32 for x in leaves)


def test_init_scales_and_determinism():
    cfg = get_config("charlstm")
    a = lstm.init_lstm_lm(torch.Generator().manual_seed(3), cfg)
    b = lstm.init_lstm_lm(torch.Generator().manual_seed(3), cfg)
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)
    d = cfg.lstm_hidden
    assert torch.equal(a["cell0"]["b"], torch.zeros(4 * d))
    for leaf in (a["cell0"]["wx"], a["cell1"]["wh"], a["embed"]["embedding"], a["head"]["w"]):
        assert abs(float(leaf.std()) * np.sqrt(d) - 1.0) < 0.02
    assert init_embed(torch.Generator(), 5, 4)["embedding"].dtype == torch.float32
    assert all(leaf.dtype == torch.float32 for leaf in tree_flatten(a)[0])


def test_embed_lookup_is_take(small):
    _, _, np_params, params, tokens, _ = small
    got = embed_lookup(params["embed"], t(tokens).long())
    want = jnp.take(np_params["embed"]["embedding"], jnp.asarray(tokens), axis=0)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_lstm_cell_matches_jax(small):
    _, _, np_params, params, _, _ = small
    rng = np.random.default_rng(1)
    x, h, c = (rng.standard_normal((B, 32)).astype(np.float32) for _ in range(3))
    jh, jc = jlstm.lstm_cell(jax.tree.map(jnp.asarray, np_params["cell0"]),
                             jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    th, tc = lstm.lstm_cell(params["cell0"], t(x), t(h), t(c))
    np.testing.assert_allclose(n(th), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(tc), np.asarray(jc), rtol=1e-5, atol=1e-6)


def test_forward_and_loss_match_jax(small):
    jcfg, tcfg, np_params, params, tokens, labels = small
    jp = jax.tree.map(jnp.asarray, np_params)
    want = jlstm.lstm_lm_apply(jp, jnp.asarray(tokens), jcfg)
    got = lstm.lstm_lm_apply(params, t(tokens).long(), tcfg)
    assert tuple(got.shape) == (B, S, 98)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    batch = {"tokens": tokens, "labels": labels}
    jl = j_build_model(jcfg).loss_fn(jp, jax.tree.map(jnp.asarray, batch))
    tl = build_model(tcfg).loss_fn(params, {k: t(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_gradients_match_jax(small):
    jcfg, tcfg, np_params, params, tokens, labels = small
    batch = {"tokens": tokens, "labels": labels}
    jg = jax.grad(j_build_model(jcfg).loss_fn)(jax.tree.map(jnp.asarray, np_params),
                                                jax.tree.map(jnp.asarray, batch))
    leaves, treedef = tree_flatten(params)
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    loss = build_model(tcfg).loss_fn(treedef.unflatten(leaves),
                                     {k: t(v).long() for k, v in batch.items()})
    tg = torch.autograd.grad(loss, leaves)
    for (path, want), got in zip(tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0], tg):
        want, got = np.asarray(want), n(got)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=path_str(path))
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=f"{path_str(path)} zeros")
    unused = np.setdiff1d(np.arange(98), tokens)
    assert unused.size and not n(tg[6])[unused].any()


# ------------------------------------------------------- tree-generic parts


NESTED = {"cell0": {"wx": (4, 8), "wh": (2, 8), "b": (8,)}, "head": {"w": (2, 5)},
          "embed": {"embedding": (5, 2)}}


def _nested(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: {kk: (scale * rng.standard_normal(s)).astype(np.float32) for kk, s in v.items()}
            for k, v in NESTED.items()}


def test_tree_map_follows_jax_tree_map():
    a, b = _nested(0), _nested(1)
    want = jax.tree.map(lambda x, y: x * 2 + y, a, b)
    got = tree_map(lambda x, y: x * 2 + y, tree_map(t, a), tree_map(t, b))
    assert _paths(got) == _paths(want)
    assert list(got) == sorted(NESTED) and list(got["cell0"]) == ["b", "wh", "wx"]
    for x, y in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_array_equal(n(x), np.asarray(y))
    with pytest.raises(ValueError, match="structure mismatch"):
        tree_map(lambda x, y: x, tree_map(t, a), {"cell0": a["cell0"]})


def test_nested_convert():
    tree = _nested(2)
    got = params_from_jax(tree, "cpu")
    assert _paths(got) == _paths(tree)
    for x, y in zip(tree_flatten(got)[0], jax.tree.leaves(tree)):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(n(x), y)
    got["cell0"]["b"][0] = 99.0  # a copy, not a view of the caller's array
    assert tree["cell0"]["b"][0] != 99.0
    state = state_from_jax({"params": tree, "opt": (), "residual": np.zeros((1, 1, 8),
                                                                         np.float32)}, "cpu")
    assert state["opt"] == () and _paths(state["params"]) == _paths(tree)
    mom = state_from_jax({"params": tree, "opt": _nested(3), "residual": np.zeros(8)}, "cpu")
    assert _paths(mom["opt"]) == _paths(tree)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_on_a_nested_tree_match_jax(name):
    params, grads = _nested(4), _nested(5, 0.1)
    jopt, topt = j_get_optimizer(name), get_optimizer(name)
    jstate, tstate = jopt.init(jax.tree.map(jnp.asarray, params)), topt.init(tree_map(t, params))
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(t, params)
    for step in range(3):
        jp, jstate = jopt.apply(jstate, jax.tree.map(jnp.asarray, grads), jp, 0.1,
                                jnp.asarray(step))
        tp, tstate = topt.apply(tstate, tree_map(t, grads), tp, 0.1, step)
    for x, y in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
        np.testing.assert_allclose(n(x), np.asarray(y), rtol=1e-6, atol=1e-7)
    mask = tree_map(lambda x: (x > 0).astype(np.float32), _nested(6))
    jm = jopt.mask(jstate, jax.tree.map(jnp.asarray, mask))
    tm = topt.mask(tstate, tree_map(t, mask))
    if name == "sgd":
        assert tm == () and jm == ()
        return
    jl = jax.tree.leaves(jm.m if name == "adam" else jm)
    tl = tree_flatten(tm.m if isinstance(tm, AdamState) else tm)[0]
    for x, y in zip(tl, jl):
        np.testing.assert_allclose(n(x), np.asarray(y), rtol=1e-6, atol=1e-7)
        assert not n(x)[np.asarray(y) == 0].any()


def test_nested_checkpoint_round_trips_both_ways(tmp_path):
    tree = params_from_jax(_nested(7), "cpu")
    save_pytree(str(tmp_path / "port.npz"), tree)
    ref = j_load_pytree(str(tmp_path / "port.npz"))
    assert sorted(ref) == sorted(p for p, _ in _paths(tree))
    back = load_pytree(str(tmp_path / "port.npz"), like=tree)
    for x, y in zip(tree_flatten(back)[0], tree_flatten(tree)[0]):
        assert torch.equal(x, y)
    j_save_pytree(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, _nested(7)))
    from_ref = load_pytree(str(tmp_path / "ref.npz"), like=tree)
    for x, y in zip(tree_flatten(from_ref)[0], tree_flatten(tree)[0]):
        assert torch.equal(x, y)
