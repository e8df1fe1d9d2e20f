"""The port's LM task (``repro_torch.data.make_lm_task``) and the
CharLSTM preset, on the CPU.

torch cannot reproduce the reference's threefry draws, so the streams
are held to the reference's contract, not its numbers: shapes and dtypes,
``labels[t] = tokens[t+1]``, one deterministic stream per ``(step,
client)``, markov rows that sum to 1 (``rtol=1e-6``) with the entropy
floor of their mean row entropy, the markov walk's transition
frequencies within 5 standard errors of its table, and the affine
recurrence ``(3x + 7) mod V`` exactly.
"""
import numpy as np
import pytest
import torch

from repro.data import make_lm_task as j_make_lm_task
from repro.run.presets import build_preset as j_build_preset
from repro_torch.data import client_batches, make_lm_task
from repro_torch.data.synthetic import markov_transition
from repro_torch.run import build_preset
from torch_helpers import n

V, B, S = 98, 4, 16


@pytest.mark.parametrize("kind", ["markov", "affine"])
def test_shapes_dtypes_and_the_label_shift(kind):
    task = make_lm_task(vocab=V, batch=B, seq_len=S, kind=kind, temperature=0.5,
                        device="cpu")
    ref = j_make_lm_task(vocab=V, batch=B, seq_len=S, kind=kind, temperature=0.5)
    b, jb = task.sample(3, 1), ref.sample(3, 1)
    assert sorted(b) == sorted(jb) == ["labels", "tokens"]
    for k in b:
        assert tuple(b[k].shape) == tuple(jb[k].shape) == (B, S)
        assert b[k].dtype == torch.int64 and b[k].device.type == "cpu"
        assert int(b[k].min()) >= 0 and int(b[k].max()) < V
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert task.vocab_size == ref.vocab_size == V and task.name == ref.name == f"lm_{kind}"


@pytest.mark.parametrize("kind", ["markov", "affine"])
def test_streams_are_deterministic_per_step_and_client(kind):
    a = make_lm_task(vocab=V, batch=B, seq_len=S, kind=kind, seed=5, device="cpu")
    b = make_lm_task(vocab=V, batch=B, seq_len=S, kind=kind, seed=5, device="cpu")
    for step, client in ((0, 0), (7, 3)):
        x, y = a.sample(step, client), b.sample(step, client)
        assert all(torch.equal(x[k], y[k]) for k in x)
    draws = [a.sample(s, c)["tokens"] for s, c in ((0, 0), (0, 1), (1, 0))]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    other = make_lm_task(vocab=V, batch=B, seq_len=S, kind=kind, seed=6, device="cpu")
    assert not torch.equal(other.sample(0, 0)["tokens"], draws[0])


def test_markov_rows_sum_to_one_and_the_floor_is_their_entropy():
    probs = markov_transition(V, 0.5, seed=0, device="cpu")
    assert tuple(probs.shape) == (V, V) and probs.dtype == torch.float32
    np.testing.assert_allclose(n(probs.sum(-1)), np.ones(V), rtol=1e-6)
    task = make_lm_task(vocab=V, batch=B, seq_len=S, temperature=0.5, device="cpu")
    p = n(probs).astype(np.float64)
    floor = float(np.mean(-np.sum(p * np.log(p + 1e-12), axis=-1)))
    np.testing.assert_allclose(task.entropy_floor, floor, rtol=1e-5)
    assert 0.0 < task.entropy_floor < np.log(V)
    # the reference's floor at the same temperature: another draw of the
    # same distribution, so close but not equal
    ref = j_make_lm_task(vocab=V, batch=B, seq_len=S, temperature=0.5)
    assert abs(task.entropy_floor - ref.entropy_floor) < 0.1 * ref.entropy_floor
    hotter = make_lm_task(vocab=V, batch=B, seq_len=S, temperature=2.0, device="cpu")
    assert hotter.entropy_floor > task.entropy_floor


def test_markov_walk_follows_its_table():
    """Over many draws, each transition's frequency from the most visited
    token is within 5 standard errors of the table's probability."""
    task = make_lm_task(vocab=V, batch=64, seq_len=64, temperature=0.5, seed=1, device="cpu")
    probs = n(markov_transition(V, 0.5, seed=1, device="cpu")).astype(np.float64)
    counts = np.zeros((V, V))
    for step in range(12):
        b = task.sample(step, 0)
        np.add.at(counts, (n(b["tokens"]).ravel(), n(b["labels"]).ravel()), 1)
    a = int(np.argmax(counts.sum(1)))
    total = counts[a].sum()
    freq = counts[a] / total
    se = np.sqrt(probs[a] * (1 - probs[a]) / total) + 1e-12
    assert total > 500 and np.all(np.abs(freq - probs[a]) <= 5 * se + 1e-9)


def test_affine_recurrence_is_exact():
    task = make_lm_task(vocab=V, batch=B, seq_len=S, kind="affine", device="cpu")
    for step in range(3):
        b = task.sample(step, 2)
        assert torch.equal(b["labels"], (3 * b["tokens"] + 7) % V)
    assert task.entropy_floor == 0.0


def test_refusals():
    # extra_fields (ROADMAP A12, part 3, items 3 and 4) runs now
    # (tests/test_torch_noniid.py): an empty one adds nothing
    task = make_lm_task(vocab=V, batch=B, seq_len=S, extra_fields=lambda g: {}, device="cpu")
    assert set(task.sample(0, 0)) == {"tokens", "labels"}
    with pytest.raises(ValueError, match="unknown LM task kind"):
        make_lm_task(vocab=V, batch=B, seq_len=S, kind="zipf", device="cpu")


def test_without_a_card_the_task_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_lm_task(vocab=V, batch=B, seq_len=S)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_preset("charlstm", batch=B, seq_len=S)
    make_lm_task(vocab=V, batch=B, seq_len=S, device="cpu")


@pytest.mark.parametrize("name", ["charlstm", "paper-lstm"])
def test_preset_is_the_references(name):
    cfg, task = build_preset(name, batch=B, seq_len=S, seed=2, device="cpu")
    jcfg, jtask = j_build_preset(name, batch=B, seq_len=S, seed=2)
    assert (cfg.name, cfg.family, cfg.vocab_size, cfg.lstm_hidden, cfg.n_layers) == (
        jcfg.name, jcfg.family, jcfg.vocab_size, jcfg.lstm_hidden, jcfg.n_layers)
    assert task.vocab_size == jtask.vocab_size == V and task.name == jtask.name
    ref = make_lm_task(vocab=V, batch=B, seq_len=S, temperature=0.5, seed=2, device="cpu")
    assert torch.equal(task.sample(1, 1)["tokens"], ref.sample(1, 1)["tokens"])
    assert task.entropy_floor == ref.entropy_floor


def test_client_batches_of_the_lm_task():
    task = make_lm_task(vocab=V, batch=B, seq_len=S, device="cpu")
    b = client_batches(task, 3, 2)(4)
    assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == (3, 2, B, S)
    for c in range(3):
        for d in range(2):
            assert torch.equal(b["tokens"][c, d], task.sample(4 * 2 + d, c)["tokens"])
