"""The port's scale planner (``repro_torch.scale``) against the JAX package's.

The reference's ``tests/test_scale_costs.py`` cases, mirrored on the port,
and every config of ``ALL_ARCHS`` priced by both planners:

  * ``classify`` at budgets 0, 96 and the default: the same (mode, reason);
  * every analytic field of ``plan_dryrun`` and ``plan_analytic`` (leaf
    count, params, Eq. 1 bits in f64 and the f32 ledger's replay, dense
    bits, compression rate, framing, memory, the sharded exchange on the
    (16, 16) stub layout, the reconcile flag): equal bit for bit;
  * ``roofline_est``: its formula on the H100 datasheet terms;
  * ``model_flops_for``: equal to the reference's for every (arch, shape);
  * ``plan_real`` on lenet5 and charlstm (the local backend on the CPU, per
    leaf): the f32 ledger replay equals the measured ledger exactly, and
    the bits a step equal the reference's and ``chip_smoke.SCALE_PINS``.
"""
import struct

import numpy as np
import pytest
import torch

from repro.core.api import make_compressor as ref_make_compressor
from repro.scale import costs as ref_costs
from repro.scale import planner as ref_planner
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.core.api import make_compressor
from repro_torch.core.channel import analytic_bits
from repro_torch.core.codec import make_codec
from repro_torch.core.policy import CompressionPolicy, PolicyRule
from repro_torch.core.wire import wire_for
from repro_torch.launch import roofline
from repro_torch.scale import costs, planner
from repro_torch.scale.costs import StubMesh
from torch_helpers import load_chip_smoke, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

FIELDS = ("n_leaves", "params", "active_params", "up_bits_per_step", "up_bits_f32_ledger",
          "dense_bits", "compression_rate", "framing_bytes", "param_bytes", "residual_bytes",
          "optimizer_bytes", "exchange_bits_per_step", "reconciles")


def _resolve(tree, policy=None):
    return (policy or make_compressor("sbc").policy).resolve(tree)


# ------------------------------------------------------- Eq. 1 walk parity


class TestUpstreamBits:
    def test_matches_channel_analytic_bits_float64(self):
        tree = {"bias": torch.zeros(7), "w": torch.zeros(4096), "emb": torch.zeros((128, 64))}
        pol = CompressionPolicy(default=make_codec("sbc"),
                                rules=(PolicyRule(r"bias", codec="dense32"),
                                       PolicyRule(r"emb", codec="skip")))
        res = _resolve(tree, pol)
        leaves = res.treedef.flatten_up_to(tree)
        rates = res.rates(0.01)
        truth = analytic_bits(res, leaves, rates)
        sizes = [int(np.prod(tuple(x.shape))) for x in leaves]
        f64, f32 = costs.upstream_bits(res, sizes, rates)
        assert f64 == truth.per_client
        assert abs(f32 - f64) <= 1e-5 * f64

    def test_framing_constants_match_sbw1_container(self):
        gen = np.random.default_rng(0)
        tree = {"a": torch.from_numpy(gen.standard_normal(2048).astype(np.float32)),
                "b": torch.from_numpy(np.random.default_rng(1).standard_normal((32, 16))
                                      .astype(np.float32))}
        res = _resolve(tree)
        state = res.init_state(tree)
        ctree, _, _ = res.compress(tree, state, res.rates(0.05))
        blob = wire_for(res, tree, 0.05).pack(ctree)
        assert blob[:4] == b"SBW1"
        (n_leaves,) = struct.unpack_from("<I", blob, 4)
        assert n_leaves == 2
        off, payload = costs.SBW1_HEADER_BYTES, 0
        for _ in range(n_leaves):
            (ln,) = struct.unpack_from("<I", blob, off)
            off += costs.SBW1_PER_LEAF_BYTES + ln
            payload += ln
        assert off == len(blob)
        assert len(blob) - payload == costs.framing_bytes(n_leaves)

    def test_memory_costs(self):
        tree = {"w": torch.zeros(1000), "v": torch.zeros(24)}
        pol = CompressionPolicy(default=make_codec("sbc"), rules=(PolicyRule(
            r"v", codec=make_codec("dense|identity|none", use_residual=False)),))
        mem = costs.memory_bytes(_resolve(tree, pol), [24, 1000], opt="adam")
        assert mem == {"param_bytes": 4 * 1024, "residual_bytes": 4 * 1000,
                       "optimizer_bytes": 2 * 4 * 1024}


# ------------------------------------------------------- sharded exchange


class TestShardedExchange:
    def test_stub_mesh_needs_no_devices(self):
        mesh = StubMesh(shape=(16, 16))
        assert mesh.shape_map == {"data": 16, "model": 16}
        assert mesh.devices.nbytes == 256

    def test_shard_count_and_scan_rows_price_like_gspmd(self):
        codec = make_codec("sbc")
        res = CompressionPolicy(default=codec).resolve({"stack/scan/mlp": torch.zeros(1)})
        leaf = torch.empty((4, 256, 1024), device="meta")
        got = costs.sharded_exchange_bits(res, [leaf], ["stack/scan/mlp"],
                                          [(None, None, "model")], [0.01], StubMesh((2, 8)))
        L, S = 4, 8
        n_loc = (4 * 256 * 1024) // (L * S)
        k_loc = max(1, int(round(0.01 * n_loc)))
        want = L * S * (codec.encoder.position_bits(n_loc, k_loc, 0.01)
                        + codec.quantizer.value_bits(k_loc))
        assert got == want

    def test_replicated_leaf_prices_once(self):
        res = CompressionPolicy(default=make_codec("sbc")).resolve({"w": torch.zeros(4096)})
        one = costs.sharded_exchange_bits(res, [torch.empty(4096, device="meta")], ["w"],
                                          [()], [0.01], StubMesh())
        assert one == costs.upstream_bits(res, [4096], res.rates(0.01))[0]

    def test_spec_tuples_count_shards_like_partition_specs(self):
        assert costs._n_shards((None, ("data", "model")), {"data": 16, "model": 16}) == 256
        assert costs._n_shards((), {"data": 16}) == 1


# ------------------------------------------------ planner classification


class TestClassification:
    def test_paper_smalls_go_real(self):
        mode, reason = planner.classify("lenet5")
        assert mode == "real" and "budget" in reason

    def test_cnn_without_preset_goes_dryrun(self):
        mode, reason = planner.classify("resnet32")
        assert mode == "dryrun" and "family" in reason

    def test_largest_goes_analytic(self):
        mode, reason = planner.classify("llama4_maverick_400b_a17b")
        assert mode == "analytic" and "cap" in reason

    def test_mode_forced(self):
        mode, reason = planner.classify("lenet5", mode="analytic")
        assert mode == "analytic" and "forced" in reason
        with pytest.raises(ValueError):
            planner.classify("lenet5", mode="bogus")

    def test_budget_moves_the_real_frontier(self):
        assert planner.classify("lenet5", budget_mb=0)[0] == "dryrun"


# ------------------------------------------ every config against the JAX planner


@pytest.mark.parametrize("arch", ref_planner.ALL_ARCHS)
def test_classify_and_analytic_fields_are_the_references(arch):
    for budget in (0, 96, planner.DEFAULT_BUDGET_MB):
        assert planner.classify(arch, budget_mb=budget) == ref_planner.classify(
            arch, budget_mb=budget), budget
    for fn in ("plan_dryrun", "plan_analytic"):
        got, want = getattr(planner, fn)(arch), getattr(ref_planner, fn)(arch)
        for f in FIELDS:
            assert got[f] == want[f], (fn, f, got[f], want[f])
        rf, cfg = got["roofline_est"], get_config(arch)
        flops = roofline.model_flops_for(cfg, INPUT_SHAPES["train_4k"], "train")
        peak = 989e12 if cfg.dtype == torch.bfloat16 else 67e12
        assert rf["compute_s"] == flops / (256 * peak)
        assert rf["memory_s"] == 2.0 * got["param_bytes"] / (256 * 3.35e12)
        bits = got["exchange_bits_per_step"] if fn == "plan_dryrun" else got["up_bits_per_step"]
        assert rf["exchange_s"] == (bits / 8.0) / (256 * 450e9)
        assert rf["step_s"] == max(rf["compute_s"], rf["memory_s"]) + rf["exchange_s"]


def test_model_flops_are_the_references():
    from repro.configs.base import get_config as ref_get_config
    from repro.launch.roofline import model_flops_for as ref_flops

    for arch in ref_planner.ALL_ARCHS:
        for name, shape in INPUT_SHAPES.items():
            got = roofline.model_flops_for(get_config(arch), shape, shape["kind"])
            assert got == ref_flops(ref_get_config(arch), shape, shape["kind"]), (arch, name)


def test_policy_for_prices_moe_experts_like_the_reference():
    for arch in ("mixtral_8x7b", "llama4_maverick_400b_a17b", "gemma3_1b"):
        got = planner.policy_for(get_config(arch))
        want = ref_planner.policy_for(ref_planner.get_config(arch))
        assert got.name == want.name
        assert [r.pattern for r in got.rules] == [r.pattern for r in want.rules]
        assert [r.rate_scale for r in got.rules] == [r.rate_scale for r in want.rules]


def test_dryrun_record_schema_and_moe_pricing():
    rec = planner.plan_dryrun("mixtral_8x7b", sparsity=0.001)
    for key in ("schema", "arch", "mode", "params", "up_bits_per_step", "up_bits_f32_ledger",
                "dense_bits", "compression_rate", "exchange_bits_per_step", "roofline_est",
                "reconciles"):
        assert key in rec, key
    assert rec["schema"] == planner.SCHEMA
    assert rec["reconciles"] is True
    assert rec["exchange_bits_per_step"] >= rec["up_bits_per_step"]
    plain = planner.plan_dryrun("mixtral_8x7b", sparsity=0.001, compressor="topk")
    assert rec["up_bits_per_step"] < plain["up_bits_per_step"]


def test_analytic_record_prices_largest_config():
    rec = planner.plan_analytic("llama4_maverick_400b_a17b", sparsity=0.001)
    assert rec["n_leaves"] is None
    assert rec["params"] > 300e9
    assert rec["compression_rate"] > 1000
    assert rec["roofline_est"]["step_s"] > 0


def test_the_costs_are_the_references_on_a_mixed_tree():
    """``leaf_bits`` of every codec kind at odd sizes and rates: the
    reference's arithmetic, bit for bit."""
    for comp in ("sbc", "topk", "signsgd", "variance", "dgc"):
        pol, ref_pol = make_compressor(comp).policy, ref_make_compressor(comp).policy
        plan, ref_plan = pol.plan_for("w"), ref_pol.plan_for("w")
        for n in (1, 7, 4096, 1_000_003):
            for p in (0.001, 0.0137, 0.5):
                assert costs.leaf_bits(plan, n, p) == ref_costs.leaf_bits(ref_plan, n, p), (
                    comp, n, p)


# ------------------------------------------------ the bit-exact reconcile


@pytest.mark.parametrize("arch", ["lenet5", "charlstm"])
def test_real_mode_reconciles_bit_exactly(arch):
    """On the executable configs the cost model's f32 ledger replay equals
    the measured ledger exactly; the bits a step are the reference's and
    the pin ``chip_smoke.py`` phase 18a holds the card's run to."""
    rec, run = planner.plan_real(arch, rounds=3, sparsity=0.01, device="cpu")
    assert rec["mode"] == "real"
    assert rec["reconciles"] is True
    r = rec["real"]
    assert r["up_bits_predicted"] == r["up_bits_ledger"]
    assert r["up_bits_ledger"] > 0
    assert len(run.ledger.records) == 3
    assert 0.5 < r["measured_ratio"] < 2.0
    want = ref_planner.plan_dryrun(arch, sparsity=0.01)
    assert rec["up_bits_per_step"] == want["up_bits_per_step"]
    assert rec["up_bits_per_step"] == load_chip_smoke().SCALE_PINS[arch]["up_bits_per_step"]
    assert r["up_bits_ledger"] == load_chip_smoke().SCALE_PINS[arch]["up_bits_ledger"]


def test_paths_find_the_repository():
    import os

    from repro_torch import paths

    root = paths.repo_root()
    assert os.path.isdir(os.path.join(root, "src", "repro_torch"))
    assert paths.experiments_dir("dryrun_torch") == os.path.join(root, "experiments",
                                                                 "dryrun_torch")
