"""CPU tests of the benchmark's harness: its files found by name, the
work it counts, the plain reference against ``repro_torch`` at a tiny
size, planted faults that the comparison must catch, and the imports the
benchmark may not make.

    python -m pytest -q perfbench/test_perfbench_harness.py
"""
from __future__ import annotations

import ast
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for sub in (BENCH, BENCH / "reference"):
    if str(sub) not in sys.path:
        sys.path.insert(0, str(sub))

import pb_flops  # noqa: E402
import pb_ref_eq1  # noqa: E402
import pb_ref_weights  # noqa: E402
import pb_spec  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
# each cell's model at a size the CPU runs in a second: every width cut,
# the structure (MoE, GQA, encoder-decoder, untied or tied head) kept
TINY = {
    "mixtral-8x7b-l1": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                            vocab_size=128),
    "seamless-m4t-medium": dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64,
                                vocab_size=100, n_layers=2, enc_layers=2),
}
SEED = 2 ** 31 + 977  # more than 32 signed bits hold


def tiny_spec(cell: str) -> dict:
    spec = pb_spec.load(cell)
    spec["config"]["model"].update(TINY[spec["cell"]["config"]])
    spec["traffic"].update(batch=2, seq_len=8, pool=4)
    if spec["traffic"].get("frames"):
        spec["traffic"]["frames"]["len"] = 8
    return spec


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_loads_by_name(cell):
    spec = pb_spec.load(cell)
    assert spec["limits"], f"{cell}: no limits/{cell}.json"
    assert set(spec["limits"]) <= {"loss_gap", "grad1_gap", "change3_gap", "eq1_gap"}
    for entry in spec["end_to_end"] + spec["per_layer"]:
        assert callable(pb_spec.reader(entry["name"]))
    names = {e["name"] for e in spec["end_to_end"]}
    assert "setup_s" in names and len(names) > 1 and spec["per_layer"]
    assert pb_ref_weights.leaf_specs(spec["config"]["model"])


def test_flops_and_bytes_are_the_hand_worked_counts():
    mixtral = pb_spec.load("mixtral-l1.b8x256")
    seamless = pb_spec.load("seamless.b8x256")
    # mixtral, one layer: a token touches q, o (2·4096²), k, v (2·4096·1024),
    # 2 of 8 experts (2·3·4096·14,336), the router (4096·8) and the head
    # (32,000·4096, untied): 525,369,344 matmul parameters; 2,048 tokens, and
    # attention 12·256·4096 a token
    assert pb_flops.round_flops(mixtral["config"]["model"], mixtral["traffic"]) == \
        6 * 525_369_344 * 2048 + 12 * 256 * 4096 * 2048
    # seamless: a decoder token 12·(4·1024² + 2·1024·4096 + 2·1024² cross q, o)
    # + the head 256,102·1024 = 438,409,216; a frame 12·(4·1024² + 2·1024·4096)
    # + 12 decoder layers' cross k, v (2·1024²) = 176,160,768; attention 12·256·1024
    # a token in 12 encoder, 12 self and 12 cross layers
    assert pb_flops.round_flops(seamless["config"]["model"], seamless["traffic"]) == \
        6 * (438_409_216 + 176_160_768) * 2048 + 36 * 12 * 256 * 1024 * 2048
    m_specs = pb_ref_weights.leaf_specs(mixtral["config"]["model"])
    s_specs = pb_ref_weights.leaf_specs(seamless["config"]["model"])
    # mixtral: the embedding and the head 2·32,000·4096, attention 2·4096² +
    # 2·4096·1024, 8 experts 3·4096·14,336 each, the router 4096·8, three norms
    assert pb_flops.entries(m_specs) == 1_713_418_240
    # seamless: 614,803,456 at NLLB's 256,206 ids, less 104·1024
    assert pb_flops.entries(s_specs) == 614_696_960
    assert pb_flops.exchange_bound_s(1_713_418_240) == 16 * 1_713_418_240 / 3.35e12
    # Eq. 1 bits a client a round, as the program's `bits_per_client` read
    # them on the card (the comparison's eq1_gap 0)
    assert pb_ref_eq1.bits_per_client(m_specs, 0.001) == 19695546.01139402
    assert pb_ref_eq1.bits_per_client(s_specs, 0.001) == 7076365.604667371


def _run_tiny(cell: str, monkeypatch=None, fault=None) -> dict:
    import run as bench

    spec = tiny_spec(cell)
    if fault is not None:
        fault(monkeypatch)
    return bench.run_cell(spec, SEED, 0.05, False, "cpu", time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_at_a_tiny_size(cell):
    out = _run_tiny(cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {e["name"] for e in pb_spec.load(cell)["end_to_end"]}


def _state_unchanged(mp):
    from repro_torch.run import GspmdRun

    step = GspmdRun.step
    mp.setattr(GspmdRun, "step", lambda self, state, r: (state, step(self, state, r)[1]))


def _half_batch(mp):
    import pb_program

    sample = pb_program.PoolTask.sample
    mp.setattr(pb_program.PoolTask, "sample", lambda self, r, client=0: {
        k: v[:v.shape[0] // 2] for k, v in sample(self, r, client).items()})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    out = _run_tiny(cell, monkeypatch, fault)
    assert not out["correct"], out["compared"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        found = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
        assert not found, f"{path.relative_to(ROOT)} imports {found}"
    for path in sorted((BENCH / "reference").rglob("*.py")):
        found = _imports(path) & {"repro_torch", "pb_program", "run"}
        assert not found, f"{path.relative_to(ROOT)} imports {found}"
