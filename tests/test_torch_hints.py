"""The port's launch hints (``repro_torch.models.hints``) and the lean MoE
against the JAX package's ``repro.models.hints`` and ``repro.models.moe``,
on the CPU.

The reference's tests of its hints without a context
(``tests/test_hints_and_specs.py::TestHintsNoop``) hold for the port's,
and the port's layout hints are identities inside a context too (PyTorch
has no GSPMD).  ``lean_moe`` is not a layout hint: under
``activation_sharding(..., lean_moe=True)`` the MoE combines in the
activations' dtype and caps its capacity factor at 1.0.  The reference
runs under ``hints.activation_sharding(make_host_mesh(), lean_moe=True)``,
the port under its own context on the same layout ``{"data": 1, "model":
1}``; the configs are ``test_torch_moe.py``'s reduced MoE configs.

Tolerances:
  * f32 (the combine stays f32 when the activations are): out and aux to
    ``rtol=1e-5`` beside ``atol=1e-5``; the capacity is the reference's
    rule at ``min(cf, 1.0)``, and the dropped share grows where the cap
    bites;
  * bf16 (a bf16 combine: at most two adds into a bf16 zero a real token,
    which round the same in either order): within 2 bf16 ulps of the
    output's scale (``atol=2·2⁻⁸·max|out|``), as the f32-combine bf16 test
    of ``test_torch_moe.py``;
  * a launch option the step does not know raises ``ValueError``, and
    ``"lean_moe"`` reaches the model through ``build_dist_train``'s step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh
from repro.models import hints as jhints
from repro.models import moe as jmoe
from repro_torch.convert import params_from_jax
from repro_torch.models import hints
from repro_torch.models import moe as tmoe
from test_torch_decoder import close, port_cfg
from test_torch_moe import CONFIGS, _reduced, xs
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HOST = {"data": 1, "model": 1}


def test_hints_are_identities_without_a_context():
    x = torch.ones((2, 8, 4))
    assert hints.act(x) is x
    y = torch.ones((4, 2, 3, 5))
    assert hints.expert_grouped(y) is y and hints.expert_flat(y) is y
    assert hints.lean_moe() is False and jhints.lean_moe() is False
    assert hints.expert_mode(16) == jhints.expert_mode(16) == "group"


@pytest.mark.parametrize("layout,expert_axis,n_experts", [
    ({"data": 16, "model": 16}, "data", 16), ({"data": 16, "model": 16}, "data", 8),
    ({"pod": 2, "data": 2, "model": 2}, "data", 4), ({"data": 4, "model": 1}, None, 8)])
def test_context_sets_and_restores_what_the_references_does(layout, expert_axis, n_experts):
    """``expert_mode`` inside a context is the reference's on the same
    layout (a shape-only mesh); ``lean_moe`` is on inside and off after;
    the layout hints stay identities."""
    class FakeMesh:
        axis_names = tuple(layout)
        devices = np.empty(tuple(layout.values()), dtype=object)

    with hints.activation_sharding(layout, batch_axes=("data",), expert_axis=expert_axis,
                                   lean_moe=True):
        with jhints.activation_sharding(FakeMesh(), expert_axis=expert_axis, lean_moe=True):
            assert hints.expert_mode(n_experts) == jhints.expert_mode(n_experts)
            assert hints.lean_moe() is True and jhints.lean_moe() is True
        x = torch.ones((4, 8, 6))
        assert hints.act(x) is x and hints.expert_flat(x) is x
    assert hints.lean_moe() is False


@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    jcfg = CONFIGS[request.param]()
    jp = jmoe.init_moe(jax.random.PRNGKey(11), jcfg)
    return request.param, jcfg, port_cfg(jcfg), jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("cf", [8.0, 1.5, 0.5])
def test_lean_moe_matches_the_reference(setup, cf):
    """f32 under ``lean_moe``: the capacity factor capped at 1.0 (so 8.0
    and 1.5 drop tokens that they would not drop without it), out, aux and
    the dropped share the reference's."""
    name, jcfg, tcfg, jp, tp = setup
    x = xs(seed=3)
    with jhints.activation_sharding(make_host_mesh(), lean_moe=True):
        jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    with hints.activation_sharding(HOST, lean_moe=True):
        tout, taux = tmoe.moe_apply(tp, t(x), tcfg, capacity_factor=cf)
        drops = tmoe.dropped_share(tp, t(x), tcfg, capacity_factor=cf)
        E, k = jcfg.moe_experts, jcfg.moe_top_k
        n_tok = x.shape[1] if jcfg.moe_dispatch == "grouped" else x.shape[0] * x.shape[1]
        assert tmoe._capacity(n_tok, k, E, cf, False) == max(
            1, int(np.ceil(n_tok * k / E * min(cf, 1.0))))
    close(tout, jout, what=f"{name} lean out")
    close(taux, jaux, what=f"{name} lean aux")
    plain = tmoe.dropped_share(tp, t(x), tcfg, capacity_factor=cf)
    assert drops >= plain
    if cf == 8.0:  # the reduced configs' own factor drops nothing; the cap does
        assert plain == 0.0 and drops > 0.0, (plain, drops)
    if cf <= 1.0:  # the cap changes nothing
        close(tout, n(tmoe.moe_apply(tp, t(x), tcfg, capacity_factor=cf)[0]),
              what="lean == plain below the cap")


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "llama4_maverick_400b_a17b"])
def test_lean_bf16_combine_matches_the_reference(arch):
    """A bf16 MoE under ``lean_moe``: the gates and the combine in bf16,
    within 2 bf16 ulps of the reference's output scale."""
    jcfg = _reduced(arch, dtype=jnp.bfloat16)
    jp = jmoe.init_moe(jax.random.PRNGKey(13), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = xs(seed=8)
    with jhints.activation_sharding(make_host_mesh(), lean_moe=True):
        jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    with hints.activation_sharding(HOST, lean_moe=True):
        tout, taux = tmoe.moe_apply(tp, t(x).to(torch.bfloat16), port_cfg(jcfg))
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout).astype(np.float32)
    close(tout.float(), want, rtol=0, atol=2 * 2 ** -8 * float(np.abs(want).max()),
          what=f"{arch} lean bf16 out")
    close(taux, jaux, what=f"{arch} lean bf16 aux")


def test_lean_combine_runs_in_the_activations_dtype():
    """The gate buffer, and so the combine, take bf16 under ``lean_moe`` and
    f32 without it."""
    experts = torch.tensor([[[0, 1], [1, 0], [0, 1]]])
    gates = torch.full((1, 3, 2), 0.5)
    x = torch.zeros((1, 3, 4), dtype=torch.bfloat16)
    assert tmoe._dispatch(experts, gates, 2, 3, 3, tmoe._acc_dtype(x))[1].dtype == torch.float32
    with hints.activation_sharding(HOST, lean_moe=True):
        assert tmoe._dispatch(experts, gates, 2, 3, 3,
                              tmoe._acc_dtype(x))[1].dtype == torch.bfloat16


def test_lean_moe_reaches_the_step_through_opts():
    """``build_dist_train(..., opts={"lean_moe"})`` installs the hint around
    each step, and only there; unknown options raise."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data import make_lm_task
    from repro_torch.launch.dist import build_dist_train

    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")), moe_capacity_factor=1.25)
    with pytest.raises(ValueError, match="unknown launch options"):
        build_dist_train(cfg, device="cpu", opts=frozenset({"expert_parallel"}))
    seen = []
    real = tmoe._capacity

    def spy(*a):
        seen.append(hints.lean_moe())
        return real(*a)

    task = make_lm_task(vocab=cfg.vocab_size, batch=2, seq_len=8, seed=0, device="cpu")
    batch = {k: v[None] for k, v in task.sample(0, 0).items()}
    tmoe._capacity = spy
    try:
        for opts in (frozenset(), frozenset({"lean_moe", "seq_every2"})):
            fns = build_dist_train(cfg, device="cpu", sparsity=0.05, opts=opts)
            fns.train_step(fns.init_state(torch.Generator().manual_seed(0)), batch)
    finally:
        tmoe._capacity = real
    half = len(seen) // 2
    assert seen and not any(seen[:half]) and all(seen[half:])
    assert hints.lean_moe() is False
