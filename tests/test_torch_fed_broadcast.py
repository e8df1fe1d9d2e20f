"""The fed backend with the broadcast DeltaLog (``RunSpec(broadcast_log=True)``)
against the JAX package's, on the CPU.

``tests/torch_fed_cases.py`` pairs the two runs: the reference's initial
parameters, numpy batches and a seeded residual in both, the reference's
cohort step without its ``jit``.  The spec is ``tests/test_broadcast.py``'s
fed case (LeNet5, 4 clients, cohorts of 2, a 5% downstream, horizon 4, 3
rounds) at lr 0, where the fed backend's parity is bit for bit
(``tests/test_torch_fed_run.py``): every upload,
the aggregate and the broadcast are the reference's bytes.  So the
ledger's down columns (the members' catch-up plans), ``_last_sync``, the
log's head, replica and entries are the reference's bit for bit, and a
``fedckpt-v1`` checkpoint with a log restores across the packages both
ways and resumes to the other package's state bit for bit.  The pool's
``rng`` entries cannot cross packages (the port keeps seeds, the
reference threefry keys; ``sbc`` reads neither), so a crossing checkpoint
takes them from the receiving package's own checkpoint of the same round.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fed.checkpoint import restore_fed_state as j_restore_fed_state
from repro.fed.checkpoint import save_fed_state as j_save_fed_state
from repro_torch.core.tree import tree_flatten
from repro_torch.fed import restore_fed_state
from repro_torch.run import RunSpec, build_run
from torch_fed_cases import LENET, paired, tasks
from torch_helpers import n, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

# tests/test_broadcast.py's fed spec at lr 0, from a seeded residual
SPEC = dict(LENET, batch=4, clients=4, cohort=2, rounds=3, lr=0.0, down_sparsity=0.05,
            broadcast_log=True, delta_horizon=4, fast=True)
RNG_KEYS = ("fixed/down/rng", "fixed/pool/rng")


def u32(x) -> np.ndarray:
    return np.ascontiguousarray(n(x), np.float32).reshape(-1).view(np.uint32)


def end_state(sched) -> dict:
    """Everything the log path leaves behind, as host copies."""
    log = sched.server.delta_log
    leaves = lambda tree: [u32(x) for x in (tree_flatten(tree)[0] if isinstance(
        next(iter(tree.values())), torch.Tensor) else jax.tree.leaves(tree))]
    return {
        "head": log.head, "oldest": log.oldest,
        "replica": [u32(r) for r in log.replica_flat()],
        "entries": [(e.round, e.blob, e.bits_measured, e.bits_analytic,
                     [None if t is None else np.asarray(t, np.int64) for t in e.touched],
                     [u32(d) for d in e.dense]) for e in log._entries],
        "last_sync": dict(sched.channel._last_sync),
        "history": sched.ledger.history(),
        "params": leaves(sched.server.params),
        "estimate": leaves(sched.server.estimate),
    }


def assert_same_state(got: dict, want: dict, what: str) -> None:
    assert (got["head"], got["oldest"]) == (want["head"], want["oldest"]), what
    assert got["last_sync"] == want["last_sync"], what
    assert got["history"] == want["history"], what
    for key in ("replica", "params", "estimate"):
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {key} leaf {i}")
    assert len(got["entries"]) == len(want["entries"]), what
    for e, je in zip(got["entries"], want["entries"]):
        assert e[:4] == je[:4], f"{what}: entry {e[0]}"
        for t, jt in zip(e[4], je[4]):
            assert (t is None) == (jt is None) and (t is None or np.array_equal(t, jt))
        for a, b in zip(e[5], je[5]):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: entry {e[0]} dense")


def crossed(src, like, out) -> str:
    """``src`` with the ``rng`` entries of ``like`` (the receiving package's
    own checkpoint of the same round): randomness cannot cross packages."""
    with np.load(src) as z, np.load(like) as other:
        arrays = {k: z[k] for k in z.files}
        for k in RNG_KEYS:
            arrays[k] = other[k]
    np.savez(out, **arrays)
    return str(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 3 rounds; checkpoints of both after round 1."""
    tmp = tmp_path_factory.mktemp("fedlog")
    jrun, jsched, trun, tsched = paired(SPEC, residual=True)
    jms, tms = [], []
    for r in range(SPEC["rounds"]):
        jms.append(jsched.step(r))
        tms.append(tsched.step(r))
        if r == 1:
            j_save_fed_state(str(tmp / "j.npz"), jsched, rounds_done=2)
            trun.checkpoint(tsched, str(tmp / "t.npz"), rounds_done=2)
    return dict(tmp=tmp, jsched=jsched, tsched=tsched, jms=jms, tms=tms,
                jend=end_state(jsched), tend=end_state(tsched))


def test_round0_pulls_nothing_and_down_columns_are_the_references(runs):
    jms, tms = runs["jms"], runs["tms"]
    assert tms[0]["down_bytes"] == 0 < tms[1]["down_bytes"]
    assert [m["down_bytes"] for m in tms] == [m["down_bytes"] for m in jms]
    th, jh = runs["tsched"].ledger.history(), runs["jsched"].ledger.history()
    assert th == jh
    recs = runs["tsched"].ledger.records
    assert all(r.down_recipients == 2 for r in recs)
    for r in recs:
        if r.down_bits_analytic > 0:
            assert abs(r.down_bits_measured - r.down_bits_analytic) <= 0.15 * r.down_bits_analytic


def test_log_last_sync_and_ledger_are_the_references(runs):
    assert_same_state(runs["tend"], runs["jend"], "port vs reference after 3 rounds")
    assert runs["tend"]["head"] == 2 and len(runs["tend"]["last_sync"]) == 4


def test_port_log_replica_is_the_port_estimate(runs):
    """Ŵ advances by ΔW* on the server and by the decoded broadcast in the
    log: the same f32 adds on the same device, so the same bits.  (The
    reference's XLA estimate flushes denormals, its numpy log keeps them;
    the port keeps them in both and is held to the reference's log.)"""
    tend = runs["tend"]
    for i, (a, b) in enumerate(zip(tend["replica"], tend["estimate"])):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_reference_checkpoint_resumes_in_the_port(runs):
    tmp = runs["tmp"]
    path = crossed(tmp / "j.npz", tmp / "t.npz", tmp / "j_in_port.npz")
    run = build_run(RunSpec(**SPEC), device="cpu")
    sched = run.init()
    sched.pool.task = tasks(SPEC)[1]
    meta = restore_fed_state(path, sched)
    assert meta["log"]["head"] == 1 and meta["last_sync"]
    sched.step(2)
    assert_same_state(end_state(sched), runs["jend"], "reference checkpoint resumed in the port")


def test_port_checkpoint_resumes_in_the_reference(runs):
    tmp = runs["tmp"]
    path = crossed(tmp / "t.npz", tmp / "j.npz", tmp / "t_in_ref.npz")
    jsched = runs["jsched"]  # at round 3: the restore rewinds it to round 2
    meta = j_restore_fed_state(path, jsched)
    assert meta["log"]["head"] == 1
    jsched.step(2)
    assert_same_state(end_state(jsched), runs["tend"], "port checkpoint resumed in the reference")


def test_checkpoint_refuses_a_log_mismatch(runs, tmp_path):
    spec = {**SPEC, "broadcast_log": False}
    run = build_run(RunSpec(**spec), device="cpu")
    with pytest.raises(ValueError, match="disagree on delta_horizon"):
        restore_fed_state(str(runs["tmp"] / "t.npz"), run.init())


# the cases that named ROADMAP A10 (tests/test_torch_fed_run.py,
# tests/test_torch_local_run.py, tests/test_torch_slice.py): each builds in
# the reference, and now runs one round in the port
SLICE = dict(preset="lenet5", backend="gspmd", fast=True, flat_engine="hist", sparsity=0.01)


@pytest.mark.parametrize("spec", [
    dict(LENET, broadcast_log=True),
    dict(preset="lenet5", backend="fed", broadcast_log=True),
    dict(SLICE, backend="fed", telemetry=True, broadcast_log=True),
    dict(SLICE, fast=False, compressor="dgc", backend="fed", broadcast_log=True),
    dict(SLICE, flat_engine="exact", fast=False, backend="fed", compressor="topk",
         broadcast_log=True),
], ids=["fed-run", "local-run", "slice-telemetry", "slice-dgc", "slice-topk"])
def test_specs_that_named_a10_run_one_round_on_the_cpu(spec):
    run = build_run(RunSpec(**spec, rounds=1), device="cpu")
    state, hist = run.run()
    assert all(np.isfinite(hist["loss"])) and len(hist["loss"]) == 1
    log = state.server.delta_log
    assert log is not None and log.head == 0 and log.horizon == 16
    rec = state.ledger.records[0]
    assert rec.down_bytes == 0 and rec.down_recipients == state.cohort_size  # nothing to pull
    assert state.channel._last_sync == {c: -1 for c in rec.cohort}
    if spec.get("telemetry"):
        names = {e["name"] for e in run.telemetry.tracer.events}
        assert "plan" in names
