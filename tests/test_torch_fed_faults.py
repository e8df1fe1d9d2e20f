"""The port's fault schedule (``repro_torch.fed.faults``) against the JAX
package's, on the CPU: both are numpy only, so every answer must be the
reference's exactly — parsing and validation, the JSON round trip, the
per-round queries, ``corrupt_blob``'s damaged bytes and
``straggler_ids``."""
import json

import numpy as np
import pytest

from repro.fed import faults as jf
from repro_torch.fed import faults as tf

SCHEDULES = [
    {},
    {"seed": 3, "drops": [[0, 1], [2, 5]]},
    {"slow": [[1, 2, 4.0], [1, 2, 6.5], [3, 0, 1.0]]},
    {"seed": 11, "corrupt": [[0, 0], [4, 7]], "kill_server": [[2, "post_aggregate"]]},
    {"drops": [[1, 1]], "slow": [[1, 3, 2.0]], "corrupt": [[1, 2]],
     "kill_server": [[0, "pre_round"], [3, "post_aggregate"]]},
]


@pytest.mark.parametrize("data", SCHEDULES)
def test_parse_and_json_round_trip_equal_the_reference(data, tmp_path):
    text = json.dumps(data)
    js, ts = jf.FaultSchedule.parse(text), tf.FaultSchedule.parse(text)
    assert ts.to_json() == js.to_json()
    assert tf.FaultSchedule.from_json(ts.to_json()) == ts
    assert tf.FaultSchedule.from_json(js.to_json()) == ts
    path = tmp_path / "faults.json"
    path.write_text(js.to_json(indent=2))
    assert tf.FaultSchedule.parse(str(path)) == ts
    assert ts.last_round() == js.last_round()
    for r in range(6):
        assert ts.drops_at(r) == js.drops_at(r)
        assert ts.corrupts_at(r) == js.corrupts_at(r)
        assert ts.kill_at(r) == js.kill_at(r)
        for c in range(8):
            assert ts.slowdown_of(r, c) == js.slowdown_of(r, c)


@pytest.mark.parametrize("bad", [
    '{"slow": [[0, 1, 0.5]]}', '{"kill_server": [[0, "mid_round"]]}',
    '{"kill_server": [[1, "pre_round"], [1, "post_aggregate"]]}', '{"dropz": []}', "[1, 2]",
    "no/such/file.json",
])
def test_invalid_schedules_raise_the_references_errors(bad):
    with pytest.raises(ValueError) as want:
        jf.FaultSchedule.parse(bad)
    with pytest.raises(ValueError) as got:
        tf.FaultSchedule.parse(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("length", [0, 5, 8, 9, 100, 4_000])
def test_corrupt_blob_gives_the_references_bytes(length):
    blob = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    for seed in (0, 7):
        js, ts = jf.FaultSchedule(seed=seed), tf.FaultSchedule(seed=seed)
        for r, c in ((0, 0), (3, 5), (12, 1)):
            got = ts.corrupt_blob(blob, r, c)
            assert got == js.corrupt_blob(blob, r, c)
            assert len(got) < len(blob) or not blob  # always loses a byte


@pytest.mark.parametrize("timeout", [None, 1.0, 2.5, 10.0])
def test_straggler_ids_equal_the_references(timeout):
    data = {"slow": [[0, 1, 3.0], [0, 4, 1.5], [1, 2, 9.0]]}
    js, ts = jf.FaultSchedule.from_json(json.dumps(data)), tf.FaultSchedule.from_json(
        json.dumps(data))
    ids = [0, 1, 2, 3, 4]
    delays = {0: 1, 1: 1, 2: 2, 3: 3, 4: 2}
    for r in (0, 1, 2):
        for sched in (None, "schedule"):
            want = jf.straggler_ids(js if sched else None, r, ids, delays, timeout)
            assert tf.straggler_ids(ts if sched else None, r, ids, delays, timeout) == want


def test_the_rest_of_the_surface_is_the_references():
    assert tf.KILL_STEPS == jf.KILL_STEPS
    assert tf.NO_FAULTS.to_json() == jf.NO_FAULTS.to_json()
    err = tf.ServerKilled(4, "post_aggregate")
    assert (err.round_idx, err.step) == (4, "post_aggregate")
    assert isinstance(err, RuntimeError) and "round 4 (post_aggregate)" in str(err)
