"""Non-IID client shards (ROADMAP A12, part 3, item 5) and the
client-sharded views, against the JAX package, on the CPU:
``make_non_iid_lm_task``'s transition tables on the reference's own
draws, its sampler's statistics (the reference's ``tests/test_fed.py::
TestNonIID``), ``split_among_clients`` (``tests/test_serve_and_io.py``'s
check), ``make_lm_task``'s ``extra_fields``, and ``non_iid`` on the fed
backend and its launcher.

torch cannot draw threefry bits, so the port's tables and walks match
the reference in formula and statistics, not in bits: the reference's
normal draws ``g`` (V, V) and ``priv`` (C, V, V) are handed across.
Tolerances:
  * the tables: ``rtol=1e-5`` beside ``atol=1e-7`` (XLA's and torch's f32
    ``exp`` and softmax sums differ in their last bits); the entropy floor
    against the reference task's own: ``rtol=1e-5``;
  * the statistics: the reference's bounds (two clients' bigram
    distributions more than 0.3 apart in L1 at skew 5; at skew 0 the
    distance across clients within 2 × the noise within one client +
    0.05);
  * the fed preset's entropy floor (the port's draws against the
    reference's: a mean over 1,024 rows) within 5%;
  * the launcher, the split and the extra fields: exact.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.data import make_non_iid_lm_task as j_make_non_iid_lm_task
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro_torch.data import make_lm_task, make_non_iid_lm_task, split_among_clients
from repro_torch.data.synthetic import _entropy_floor, non_iid_transition
from repro_torch.run import RunSpec, build_run
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("skew, temperature", [(2.0, 0.5), (5.0, 0.3), (0.0, 1.0)])
def test_tables_are_the_references_formula_on_its_draws(skew, temperature):
    """The reference's draws (``fold_in(PRNGKey(seed), 17)`` and ``29``)
    through the port's ``non_iid_transition``: the reference's formula, and
    the entropy floor of the reference's own task."""
    V, C, seed = 24, 3, 5
    base = jax.random.PRNGKey(seed)
    g = jax.random.normal(jax.random.fold_in(base, 17), (V, V))
    priv = jax.random.normal(jax.random.fold_in(base, 29), (C, V, V))
    lam = skew / (1.0 + skew)
    want = jax.nn.softmax(((1.0 - lam) * g[None] + lam * priv) / max(temperature, 1e-3), axis=-1)
    got = non_iid_transition(t(g), t(priv), skew, temperature)
    assert got.shape == (C, V, V)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-7)
    ref = j_make_non_iid_lm_task(vocab=V, batch=2, seq_len=4, n_clients=C, skew=skew,
                                 temperature=temperature, seed=seed)
    np.testing.assert_allclose(_entropy_floor(got), ref.entropy_floor, rtol=1e-5)


def _bigrams(task, client, steps, vocab):
    """Empirical bigram distribution of one client's stream over ``steps``
    (the reference test's helper)."""
    h = np.zeros((vocab, vocab))
    for s in steps:
        tok = n(task.sample(s, client)["tokens"])
        np.add.at(h, (tok[:, :-1].ravel(), tok[:, 1:].ravel()), 1)
    return h / h.sum()


def test_clients_draw_from_distinct_chains():
    task = make_non_iid_lm_task(vocab=32, batch=8, seq_len=64, n_clients=4, skew=5.0,
                                temperature=0.3, seed=0, device="cpu")
    a, b = _bigrams(task, 0, [0], 32), _bigrams(task, 1, [0], 32)
    assert np.abs(a - b).sum() > 0.3
    assert task.entropy_floor > 0 and task.name == "lm_markov_noniid4"


def test_skew_zero_is_shared_chain():
    task = make_non_iid_lm_task(vocab=32, batch=8, seq_len=64, n_clients=4, skew=0.0,
                                temperature=0.3, seed=0, device="cpu")
    noise = np.abs(_bigrams(task, 0, [0, 1], 32) - _bigrams(task, 0, [2, 3], 32)).sum()
    cross = np.abs(_bigrams(task, 0, [0, 1], 32) - _bigrams(task, 1, [0, 1], 32)).sum()
    assert cross < 2.0 * noise + 0.05


def test_the_stream_is_stateless_and_wraps_clients():
    """A sample is a function of (step, client); client c + n_clients
    walks client c's chain from another stream; labels are the next
    tokens."""
    task = make_non_iid_lm_task(vocab=16, batch=4, seq_len=8, n_clients=2, device="cpu")
    a, b = task.sample(3, 1), task.sample(3, 1)
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].shape == (4, 8)
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert not torch.equal(a["tokens"], task.sample(3, 3)["tokens"])


def test_split_among_clients_gives_disjoint_streams():
    """``tests/test_serve_and_io.py``'s check, and each row is that
    client's sample."""
    task = make_lm_task(vocab=50, batch=2, seq_len=8, device="cpu")
    b = split_among_clients(task, 3)(0)
    assert b["tokens"].shape[0] == 3
    assert not np.array_equal(n(b["tokens"][0]), n(b["tokens"][1]))
    for c in range(3):
        assert torch.equal(b["tokens"][c], task.sample(0, c)["tokens"])


def test_extra_fields_come_from_the_samples_generator():
    """``extra_fields(g)`` draws after the tokens from the sample's own
    generator: the same (step, client) gives the same fields and tokens as
    without them; another gives other fields."""
    task = make_lm_task(vocab=20, batch=2, seq_len=6, device="cpu",
                        extra_fields=lambda g: {"x": torch.randn((2, 3), generator=g)})
    plain = make_lm_task(vocab=20, batch=2, seq_len=6, device="cpu")
    a = task.sample(1, 2)
    assert torch.equal(a["x"], task.sample(1, 2)["x"]) and a["x"].shape == (2, 3)
    assert torch.equal(a["tokens"], plain.sample(1, 2)["tokens"])
    assert not torch.equal(a["x"], task.sample(2, 2)["x"])


def test_non_iid_runs_on_the_fed_backend():
    """fed-tiny with ``non_iid`` (4 clients, skew 2): the task is the
    clients' own chains, whose entropy floor (a mean over 1,024 rows of
    other draws) is the reference task's within 5%; one round runs and the
    ledger reconciles."""
    run = build_run(RunSpec(preset="fed-tiny", backend="fed", non_iid=True, skew=2.0, clients=4,
                            cohort=2, rounds=1, batch=2, seq_len=16, sparsity=0.05),
                    device="cpu")
    assert run.task.name == "lm_markov_noniid4"
    jtask = j_build_run(JRunSpec(preset="fed-tiny", backend="fed", non_iid=True, clients=4,
                                 batch=2, seq_len=16)).task
    np.testing.assert_allclose(run.task.entropy_floor, jtask.entropy_floor, rtol=0.05)
    _, hist = run.run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    run.ledger.reconcile(rel=0.25)


def test_fed_launcher_says_non_iid():
    from repro_torch.launch.fed import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--non-iid", "--skew", "2.0", "--rounds", "1", "--clients", "4", "--cohort", "2",
              "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert ", non-IID, " in out.getvalue().splitlines()[0]


def test_chip_smoke_noniid_pin_is_the_fed_launchers(monkeypatch):
    """``chip_smoke.py`` phase 14d's ``NONIID_PER_ROUND``: the
    ``f32_mean_xla`` calls of one round of the fed launcher's non-IID run
    (``NONIID_ARGV``: 16 clients, per leaf, a 5% downstream), counted on
    the CPU where each call is the plain cascade."""
    from repro_torch.core import stages
    from repro_torch.kernels import topk
    from repro_torch.launch import fed
    from repro_torch.run.flags import spec_from_args
    from torch_helpers import load_chip_smoke

    smoke = load_chip_smoke()
    spec = spec_from_args(fed.build_parser().parse_args(smoke.NONIID_ARGV), backend="fed")
    assert (spec.preset, spec.clients, spec.non_iid, spec.skew) == ("fed-tiny", 16, True, 2.0)
    sched = build_run(spec, device="cpu").init()
    calls = []
    for mod in (topk, stages):
        mean = mod.f32_mean_xla
        monkeypatch.setattr(mod, "f32_mean_xla",
                            lambda *a, _m=mean, **k: calls.append(1) or _m(*a, **k))
    sched.step(0)
    want = {k: v for k, v in smoke.NONIID_PER_ROUND.items() if v}
    assert want == {"f32_mean_xla": len(calls)}
