"""The port's DeltaLog and SBD1 catch-ups against the JAX package's, on the
CPU (the counterpart of ``tests/test_delta_stack.py``).

The reference's own compressors draw the updates (``drive_log``, its seeds)
and pack them; the SAME SBW1 blobs are appended to both packages' logs, so
the stochastic codecs (``qsgd``) need no randomness across packages.  Then
every ``LogEntry`` (``touched``, ``dense``, both bit counts), the replica
after every round, the ``encode_stacked(a)`` bytes for every ``a`` in the
window, ``encode_full()`` and ``full_nbytes()`` are the reference's bit for
bit, and stacked, replay and full catch-ups give the sequential replica bit
for bit.  The reference's fuzz harness (truncation sweep, 200 seeded
corruptions) raises ``ValueError`` in the port exactly where it does in the
reference, and gives equal replicas where it succeeds.  No tolerance:
every comparison is of bit patterns.
"""
import random
import struct

import jax
import numpy as np
import pytest
import torch

from repro.core.api import make_compressor as j_make_compressor
from repro.core.stages import LeafCompressed as JLeafCompressed
from repro.core.wire import wire_for as j_wire_for
from repro.serve.deltalog import DeltaLog as JDeltaLog
from repro.serve.deltalog import apply_catchup_flat as j_apply
from repro_torch.core.api import make_compressor
from repro_torch.core.codec import make_codec
from repro_torch.core.policy import CompressionPolicy, PolicyRule
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.wire import wire_for
from repro_torch.serve import CatchupPlanner, DeltaLog, apply_catchup, apply_catchup_flat
from repro_torch.serve.deltalog import CATCHUP_MAGIC
from test_delta_stack import CODECS, drive_log, rate_of
from torch_helpers import n


def u32(x) -> np.ndarray:
    return np.ascontiguousarray(n(x), np.float32).reshape(-1).view(np.uint32)


def assert_bits_equal(got, want, ctx=""):
    assert len(got) == len(want), ctx
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(u32(a), u32(b), err_msg=f"leaf {i} {ctx}")


def port_log(jlog: JDeltaLog, params: dict, wire, horizon: int) -> DeltaLog:
    """A port log fed the reference log's own held blobs, in order."""
    log = DeltaLog(params, horizon=horizon, device="cpu")
    for e in jlog._entries:
        log.append(e.round, e.blob, wire, bits_analytic=e.bits_analytic)
    return log


@pytest.fixture(scope="module", params=CODECS)
def logs(request):
    """(name, reference log and snapshots, port log and snapshots, port
    wire, initial params) for one codec, 6 rounds, horizon 16."""
    name = request.param
    jlog, jsnaps = drive_log(name, rate_of(name))
    params = dict(zip(("b", "w"), (np.asarray(x).reshape(s) for x, s in
                                   zip(jsnaps[-1], jlog._shapes))))
    wire = wire_for(make_compressor(name).resolve(params), params, rate_of(name))
    log = DeltaLog(params, horizon=16, device="cpu")
    snaps = {-1: log.replica_flat()}
    for e in jlog._entries:
        log.append(e.round, e.blob, wire)
        snaps[e.round] = log.replica_flat()
    return name, jlog, jsnaps, log, snaps, wire, params


def test_entries_and_every_rounds_replica_are_the_references(logs):
    _, jlog, jsnaps, log, snaps, _, _ = logs
    assert (log.head, log.oldest, log.n_params) == (jlog.head, jlog.oldest, jlog.n_params)
    for r in jsnaps:
        assert_bits_equal(snaps[r], jsnaps[r], f"replica after round {r}")
    for e, je in zip(log._entries, jlog._entries):
        assert (e.round, e.blob, e.nbytes) == (je.round, je.blob, je.nbytes)
        assert (e.bits_measured, e.bits_analytic) == (je.bits_measured, je.bits_analytic)
        for t, jt in zip(e.touched, je.touched):
            assert (t is None) == (jt is None)
            if t is not None:
                assert t.dtype == np.int64 and np.array_equal(t, jt)
        assert_bits_equal(e.dense, je.dense, f"round {e.round} dense")
        assert all(d.dtype == torch.float32 for d in e.dense)


def test_stacked_and_full_bytes_are_the_references(logs):
    _, jlog, _, log, _, _, _ = logs
    for frm in range(-1, log.head):
        got, want = log.encode_stacked(frm), jlog.encode_stacked(frm)
        assert got.blob == want.blob, f"stacked from {frm}"
        assert got[:3] == want[:3] and got[4:] == want[4:]
    got, want = log.encode_full(), jlog.encode_full()
    assert got.blob == want.blob and got[4:] == want[4:]
    assert log.full_nbytes() == jlog.full_nbytes() == got.nbytes


def test_stacked_replay_and_full_equal_sequential_every_lag(logs):
    """From every held round: stacked-apply == sequential replay == the
    log's replica == a full resync of a garbage replica, bit for bit."""
    _, _, _, log, snaps, _, _ = logs
    final = log.replica_flat()
    full = log.encode_full().blob
    for frm in range(-1, log.head):
        seq = [f.clone() for f in snaps[frm]]
        for e in log.entries_since(frm):
            seq = [f + d for f, d in zip(seq, e.dense)]
        stk, f0, t0 = apply_catchup_flat(snaps[frm], log.encode_stacked(frm).blob)
        assert (f0, t0) == (frm, log.head)
        assert_bits_equal(stk, seq, f"(stacked vs sequential, from {frm})")
        assert_bits_equal(stk, final, f"(stacked vs replica, from {frm})")
    garbage = [torch.full_like(f, 9.9) for f in final]
    got, frm, to = apply_catchup_flat(garbage, full)
    assert (frm, to) == (-1, log.head)
    assert_bits_equal(got, final, "(full)")


def test_restore_of_state_dict_is_the_same_log(logs):
    name, jlog, _, log, _, wire, params = logs
    st = log.state_dict()
    assert all(isinstance(r, np.ndarray) and r.dtype == np.float32 for r in st["replica"])
    back = DeltaLog(params, horizon=16, device="cpu")
    back.restore(st, wire_for_round=lambda r: wire)
    assert back.head == log.head and back.oldest == log.oldest
    assert_bits_equal(back.replica_flat(), jlog.replica_flat(), "restored replica")
    assert [e.blob for e in back._entries] == [e.blob for e in jlog._entries]
    assert back.encode_stacked(-1).blob == jlog.encode_stacked(-1).blob
    # a reference state_dict restores into the port and the other way round
    into = DeltaLog(params, horizon=16, device="cpu")
    into.restore(jlog.state_dict(), wire_for_round=lambda r: wire)
    assert_bits_equal(into.replica_flat(), jlog.replica_flat(), "reference state")
    jback = JDeltaLog(params, horizon=16)
    jwire = j_wire_for(j_make_compressor(name).resolve(params), params, rate_of(name))
    jback.restore(st, wire_for_round=lambda r: jwire)
    assert jback.encode_stacked(-1).blob == log.encode_stacked(-1).blob


@pytest.mark.parametrize("frm", [2, 4, 6])
def test_residual_codec_window_interior(frm):
    """sbc carries a residual, so values sent late depend on what earlier
    rounds dropped: stacking from inside the window of 8 rounds gives the
    reference's bytes and the replica."""
    jlog, jsnaps = drive_log("sbc", 0.01, rounds=8)
    params = {"b": jsnaps[-1][0].reshape(61), "w": jsnaps[-1][1].reshape(3000)}
    wire = wire_for(make_compressor("sbc").resolve(params), params, 0.01)
    log = port_log(jlog, params, wire, 16)
    msg = log.encode_stacked(frm)
    assert msg.blob == jlog.encode_stacked(frm).blob
    stk, _, _ = apply_catchup_flat([torch.from_numpy(x) for x in jsnaps[frm]], msg.blob)
    assert_bits_equal(stk, log.replica_flat())


def test_evicted_window_falls_back_to_the_references_full():
    jlog, _ = drive_log("sbc", 0.01, rounds=8, horizon=3)
    params = {"b": np.zeros(61, np.float32), "w": np.zeros(3000, np.float32)}
    wire = wire_for(make_compressor("sbc").resolve(params), params, 0.01)
    # the held window only: restore the reference's state into the port
    log = DeltaLog(params, horizon=3, device="cpu")
    log.restore(jlog.state_dict(), wire_for_round=lambda r: wire)
    assert log.oldest == jlog.oldest == 5 and not log.can_stack(0)
    plan = CatchupPlanner(log).plan(0)
    assert plan.kind == "full" and plan.blobs[0] == jlog.encode_full().blob
    with pytest.raises(ValueError, match="not fully held"):
        log.entries_since(0)


def test_skip_and_sparse_leaves_compose():
    """A skipped leaf rides MODE_EMPTY yet its −0.0 flips to +0.0 as on a
    sequential receiver; the reference's policy, blobs and bytes."""
    from repro.core.codec import make_codec as j_make_codec
    from repro.core.policy import CompressionPolicy as JPolicy
    from repro.core.policy import PolicyRule as JRule

    params = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2000,)) * 0.01),
              "b": np.float32([1.0, -0.0, 2.0, 0.0, -3.0])}
    jres = JPolicy(default=j_make_codec("sbc"), rules=(JRule("b", codec="skip"),),
                   name="sbc+skip-b").resolve(params)
    res = CompressionPolicy(default=make_codec("sbc"), rules=(PolicyRule("b", codec="skip"),),
                            name="sbc+skip-b").resolve(params)
    jwire, wire = j_wire_for(jres, params, 0.02), wire_for(res, params, 0.02)
    assert jwire.specs == wire.specs
    state = jres.init_state(params)
    jlog, log = JDeltaLog(params, horizon=8), DeltaLog(params, horizon=8, device="cpu")
    snap0 = log.replica_flat()
    key = jax.random.PRNGKey(5)
    for r in range(4):
        key, k1 = jax.random.split(key)
        delta = {"w": 0.01 * jax.random.normal(k1, (2000,)), "b": np.float32([0.5] * 5)}
        ctree, _, state = jres.compress(delta, state, jres.rates(0.02, r))
        blob = jwire.pack(jax.tree.map(np.asarray, ctree))
        jlog.append(r, blob, jwire)
        log.append(r, blob, wire)
    assert log.encode_stacked(-1).blob == jlog.encode_stacked(-1).blob
    assert_bits_equal(log.replica_flat(), jlog.replica_flat())
    stk, _, _ = apply_catchup_flat(snap0, log.encode_stacked(-1).blob)
    assert_bits_equal(stk, log.replica_flat())
    b = stk[0]
    assert b.numel() == 5 and b[0] == 1.0 and b[2] == 2.0 and not torch.signbit(b[1])


def test_minus_zero_transmitted_position_flips_sign():
    """A transmitted +0.0 landing on a stored −0.0 flips the sign bit: the
    union comes from the transmitted index sets, and the port's bytes and
    replica are the reference's."""
    params = {"w": np.float32([0, 0, -0.0, 0, 0, -0.0, 0, 0])}
    jcomp = j_make_compressor("topk")
    jwire = j_wire_for(jcomp.resolve(params), params, 0.125)
    wire = wire_for(make_compressor("topk").resolve(params), params, 0.125)
    jctree = {"w": JLeafCompressed(idx=np.int32([5]), vals=np.float32([0.0]),
                                   mean=np.zeros((), np.float32),
                                   dense=np.zeros((0,), np.float32),
                                   nbits=np.zeros((), np.float32))}
    ctree = {"w": LeafCompressed(*(torch.from_numpy(np.asarray(x)) for x in jctree["w"]))}
    blob = wire.pack(ctree)
    assert blob == jwire.pack(jctree)
    jlog, log = JDeltaLog(params, horizon=4), DeltaLog(params, horizon=4, device="cpu")
    snap0 = log.replica_flat()
    jlog.append(0, blob, jwire)
    log.append(0, blob, wire)
    rep = log.replica_flat()[0]
    assert not torch.signbit(rep[5]) and not torch.signbit(rep[2])
    assert_bits_equal(log.replica_flat(), jlog.replica_flat())
    msg = log.encode_stacked(-1)
    assert msg.blob == jlog.encode_stacked(-1).blob
    stk, _, _ = apply_catchup_flat(snap0, msg.blob)
    assert_bits_equal(stk, log.replica_flat())
    # the +0.0 add before the scatter is what flips the untouched −0.0
    assert not torch.signbit(stk[0][2])


def test_apply_catchup_tree_roundtrip(logs):
    _, jlog, _, log, snaps, _, _ = logs
    replica = log.treedef.unflatten([f.clone() for f in snaps[1]])
    tree, frm, to = apply_catchup(replica, log.encode_stacked(1).blob)
    assert (frm, to) == (1, log.head)
    assert_bits_equal([tree["b"], tree["w"]], jlog.replica_flat())
    assert tuple(tree["w"].shape) == (3000,)


# ------------------------------------------------------------- fuzz/harden


@pytest.fixture(scope="module")
def stacked():
    jlog, jsnaps = drive_log("sbc", 0.01, rounds=5)
    return [x.copy() for x in jsnaps[-1]], jlog.encode_stacked(-1).blob


def both(flats, blob):
    """The reference's and the port's outcome: the replica, or ValueError."""
    out = []
    for fn in (j_apply, apply_catchup_flat):
        try:
            got, frm, to = fn([x.copy() for x in flats], blob)
            out.append((frm, to, [u32(g) for g in got]))
        except ValueError:
            out.append("ValueError")
    return out


def assert_same_outcome(flats, blob, what):
    want, got = both(flats, blob)
    if want == "ValueError" or got == "ValueError":
        assert got == want, what
        return
    assert got[:2] == want[:2], what
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_truncation_sweep_fails_where_the_reference_fails(stacked):
    flats, blob = stacked
    step = max(1, len(blob) // 80)
    for cut in list(range(0, len(blob), step)) + [len(blob) - 1, len(blob)]:
        assert_same_outcome(flats, blob[:cut], f"cut at {cut}")


def test_random_corruption_fails_where_the_reference_fails(stacked):
    flats, blob = stacked
    rng = random.Random(99)
    for i in range(200):
        b = bytearray(blob)
        for _ in range(rng.randint(1, 8)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        assert_same_outcome(flats, bytes(b), f"corruption {i}")


def test_bad_magic_kind_and_leaf_count_give_the_references_errors(stacked):
    flats, blob = stacked
    bad = [b"XXXX" + blob[4:], blob[:8]]
    for off, value in ((4, 77),):
        b = bytearray(blob)
        b[off] = value
        bad.append(bytes(b))
    b = bytearray(blob)
    struct.pack_into("<I", b, 4 + 9, 1000)
    bad.append(bytes(b))
    for blob_ in bad:
        with pytest.raises(ValueError) as want:
            j_apply(flats, blob_)
        with pytest.raises(ValueError) as got:
            apply_catchup_flat(flats, blob_)
        assert str(got.value) == str(want.value)
    assert blob[:4] == CATCHUP_MAGIC


def test_log_contract_errors_are_the_references():
    params = {"w": np.zeros((64,), np.float32)}
    for horizon in (0, -1):
        with pytest.raises(ValueError) as want:
            JDeltaLog(params, horizon=horizon)
        with pytest.raises(ValueError) as got:
            DeltaLog(params, horizon=horizon, device="cpu")
        assert str(got.value) == str(want.value)
    jlog, log = JDeltaLog(params, horizon=4), DeltaLog(params, horizon=4, device="cpu")
    comp = make_compressor("topk")
    wire = wire_for(comp.resolve(params), params, 0.1)
    ctree, _, _ = comp.compress({"w": torch.ones(64)}, comp.init_state({"w": torch.zeros(64)}),
                                0.1)
    blob = wire.pack(ctree)
    jwire = j_wire_for(j_make_compressor("topk").resolve(params), params, 0.1)
    for call in (lambda lg, w: lg.append(3, blob, w), lambda lg, w: lg.encode_stacked(-1)):
        with pytest.raises(ValueError) as want:
            call(jlog, jwire)
        with pytest.raises(ValueError) as got:
            call(log, wire)
        assert str(got.value) == str(want.value)


def test_the_log_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"w": np.zeros((8,), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DeltaLog(params, horizon=2)
    assert DeltaLog(params, horizon=2, device="cpu").replica_flat()[0].device.type == "cpu"
