"""The dry run on the ``meta`` device (``repro_torch.launch.dryrun``) and its
roofline counts (``repro_torch.launch.roofline``), on the CPU.

  * each kernel wrapper given ``meta`` tensors returns its plain version's
    shapes and dtypes, counts one call and its bound's bytes in
    ``_build.META_TALLY``, and leaves the card's ``launches`` alone;
  * the recording group's collectives return what a real group returns
    and record what they move;
  * on a reduced dense decoder the counted FLOPs equal a hand count of the
    step's GEMMs and attention products, ``2·m·n·k`` each, exactly;
  * a sampled host loop (RWKV6's and Mamba's recurrences) counts the FLOPs
    and the peak memory of the whole loop exactly;
  * four full-size pairs run to ``ok`` on the single-pod layout, and
    every skip is the reference's;
  * ``make_dist_prefill`` of an untied head (which the dry run found
    refused) prefills.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro_torch.configs.base import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, reduced
from repro_torch import kernels
from repro_torch.kernels import _build, binarize_apply, flat, hist2side, moments, pack, reduce
from repro_torch.launch import dryrun, roofline
from repro_torch.models import hints
from torch_helpers import torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _seg_params(nblocks: int, ncols: int) -> torch.Tensor:
    p = torch.zeros((nblocks, ncols))
    p[:, 1:] = torch.tensor([1e-3, 1.0, 1e-3, 1.0][:ncols - 1])
    return p


# (name, wrapper, cpu args, kwargs, bytes its bound counts)
N, NB = 4 * 8 * 128, 4
CALLS = [
    ("seg_hist2side", flat.seg_hist2side, (_f32(NB * 8, 128), _seg_params(NB, 5)),
     dict(nseg=2), 4 * (N + NB * 5 + 2 * 2 * 128)),
    ("seg_moments", flat.seg_moments, (_f32(NB * 8, 128), _seg_params(NB, 3)),
     dict(nseg=2), 4 * (N + NB * 3 + 2 * 2 * 2)),
    ("seg_binarize_apply", flat.seg_binarize_apply, (_f32(NB * 8, 128), _seg_params(NB, 4)),
     {}, 4 * (3 * N + NB * 4)),
    ("seg_packbits", pack.seg_packbits, (torch.randint(0, 2, (32, 256), dtype=torch.int32),),
     {}, 4 * (32 * 256 + 256)),
    ("seg_packbits", pack.seg_packbits_stream, (torch.randint(0, 2, (1000,),
                                                              dtype=torch.int32),),
     {}, 4 * (1000 + 32)),
    ("seg_select_pack", pack.seg_select_pack,
     ((torch.arange(3 * 64).reshape(3, 64) % 8 == 0).to(torch.int32),), dict(k=8, bstar=2),
     4 * (3 * 64 + 3 * pack.row_words(64, 8, 2) + 3)),
    ("hist2side", hist2side.hist2side, (_f32(5000), 1e-3, 1.0), {}, 4 * (5000 + 4 + 2 * 128)),
    ("masked_moments", moments.masked_moments, (_f32(5000), 0.5, 0.5), {}, 4 * (5000 + 6)),
    ("binarize_apply", binarize_apply.binarize_apply, (_f32(5000), 0.5, 0.5, 1.0, 1.0), {},
     4 * (3 * 5000 + 4)),
    ("f32_mean_xla", reduce.f32_mean_xla, (_f32(3, 7, 100),), {}, 4 * (2100 + 21)),
]


def _outs(x) -> list:
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("call", CALLS, ids=[c[1].__name__ for c in CALLS])
def test_meta_branch_gives_the_plain_shapes_and_counts_one_call(call):
    name, fn, args, kw, nbytes = call
    want = _outs(fn(*args, **kw))  # the CPU route: the plain version
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    launches = kernels.launch_counts()
    _build.reset_meta()
    got = _outs(fn(*meta, **kw))
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == [
        (tuple(w.shape), w.dtype, "meta") for w in want]
    assert _build.META_TALLY == {name: [1, nbytes]}
    assert kernels.launch_counts() == launches


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no-residual"])
def test_seg_accumulate_meta_branch_counts_one_call(residual):
    """``seg_accumulate`` on ``meta`` leaves: the plain shapes, one call of
    the leaves and residual read and ``acc`` and the maxima written."""
    leaves, bounds = [_f32(1000), _f32(3, 1024)], [(0, 1000), (1024, 3072)]
    res = _f32(4 * 1024) if residual else None
    want = flat.seg_accumulate(leaves, res, bounds, 4 * 1024)
    launches = kernels.launch_counts()
    _build.reset_meta()
    got = flat.seg_accumulate([x.to("meta") for x in leaves],
                              None if res is None else res.to("meta"), bounds, 4 * 1024)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == [
        (tuple(w.shape), w.dtype, "meta") for w in want]
    read = 4072 + (4096 if residual else 0)
    assert _build.META_TALLY == {"seg_accumulate": [1, 4 * (read + 4096 + 2)]}
    assert kernels.launch_counts() == launches


def test_other_devices_are_still_refused():
    class Elsewhere:
        device = torch.device("xla")

    with pytest.raises(ValueError, match="unsupported device"):
        _build.check_device(Elsewhere())


def test_recording_group_returns_a_groups_shapes_and_records_them():
    log = dryrun.CallLog()
    g = dryrun.RecordingGroup.of(8, rank=3, log=log)
    t = torch.empty((2, 5), dtype=torch.float32, device="meta")
    assert g.all_gather_rows(t).shape == (8, 2, 5)
    assert g.pmean(t, (2, 4)).shape == (2, 5)
    assert g.exchange_rows(torch.empty((8, 3), device="meta")).shape == (8, 3)
    assert [c["kind"] for c in log.calls] == ["all-gather", "all-gather", "all-to-all"]
    assert log.calls[0]["bytes"] == 8 * 2 * 5 * 4 and log.calls[2]["bytes"] == 8 * 3 * 4
    ranks = g.device_ranks({"pod": 2, "data": 2, "model": 2}, ("pod", "data"))
    assert ranks.client == 1 and ranks.device == 1
    assert ranks.exchange.members == (1, 3, 5, 7) and ranks.client_ranks.members == (2, 3)
    assert ranks.model.members == (2, 3) and ranks.batch.members == (1, 3, 5, 7)
    ranks.client_ranks.gather_list(t)
    assert log.calls[-1]["members"] == [2, 3] and log.calls[-1]["world"] == 2


def _hand_flops(cfg, B: int, S: int, remat: bool) -> int:
    """Every GEMM of one train step of a dense decoder on B rows of S
    tokens, 2·m·n·k each: the forward's projections, MLP and attention
    products a layer and the head's logits; the backward takes two GEMMs
    of each; with ``remat`` (a rank-sharded step) each superblock's
    forward runs again in the backward up to the last tensor its backward
    saved (``torch.utils.checkpoint`` stops early): all but each layer's
    down projection, whose output nothing saves."""
    T, d, ff, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    proj = 2 * T * d * (q + 2 * kv) + 2 * T * q * d
    mlp = 2 * T * d * ff * (3 if cfg.gated_mlp else 2)
    attn = 2 * (2 * B * cfg.n_heads * S * S * cfg.head_dim)
    head = 2 * T * d * V
    layer = proj + mlp + attn
    again = layer - 2 * T * ff * d if remat else 0
    return cfg.n_layers * (3 * layer + again) + 3 * head


# (arch, layout, the rows a rank steps of the 4 a client): qwen1.5 on one
# device; granite (pod mode) on 4 ranks of one device each, 2 rows a
# "data" rank and remat
FLOP_CASES = [("qwen15_4b", {"data": 1, "model": 1}, 4),
              ("granite_20b", {"data": 2, "model": 2}, 2)]


@pytest.mark.parametrize("arch,layout,rows", FLOP_CASES, ids=[c[0] for c in FLOP_CASES])
def test_counted_flops_are_the_hand_count(arch, layout, rows):
    cfg = reduced(get_config(arch), residual_dtype=torch.float32)
    S = 16
    batch = {"tokens": torch.zeros((1, 4, S), dtype=torch.int32),
             "labels": torch.zeros((1, 4, S), dtype=torch.int32)}
    got = dryrun.dry_train(cfg, layout, batch, fast=False)
    sharded = got["fns"].ranks is not None
    assert sharded == (layout["data"] * layout["model"] > 1)
    assert got["counter"].total_flops == _hand_flops(cfg, rows, S, remat=sharded and cfg.remat)
    assert set(got["counter"].flops) == {"float32"}
    assert got["kernels"]["f32_mean_xla"]["launches"] == len(got["fns"].channel.leaves) + 1


# (arch, rows, sequence): the recurrences' loops over 16 positions, and
# attention's 4 query chunks of 1,024 under remat
SAMPLED = [("rwkv6_1p6b", 4, 16), ("jamba_v01_52b", 4, 16), ("granite_20b", 2, 4096)]


@pytest.mark.parametrize("arch,rows,seq", SAMPLED, ids=[c[0] for c in SAMPLED])
def test_a_sampled_loop_counts_the_whole_loop(arch, rows, seq):
    """Two steps of a host loop stand for all of them (the recurrences'
    positions, attention's query chunks): the FLOPs and the peak live
    bytes equal an unsampled run's; the op bytes stay at or below it (the
    engine's gradient adds over the steps are counted for the two steps
    run)."""
    cfg = reduced(get_config(arch))
    batch = {"tokens": torch.zeros((1, rows, seq), dtype=torch.int32),
             "labels": torch.zeros((1, rows, seq), dtype=torch.int32)}
    layout = {"data": 2, "model": 2}
    sampled = dryrun.dry_train(cfg, layout, batch)
    real = hints.sampled_loops
    try:
        hints.sampled_loops = lambda sampler: real(None)
        whole = dryrun.dry_train(cfg, layout, batch)
    finally:
        hints.sampled_loops = real
    assert sampled["loops"] and not whole["loops"]
    assert sampled["counter"].flops == whole["counter"].flops
    assert sampled["temp_bytes"] == whole["temp_bytes"]
    assert 0.8 * whole["counter"].bytes <= sampled["counter"].bytes <= whole["counter"].bytes
    assert [c["kind"] for c in sampled["log"].calls] == [c["kind"] for c in whole["log"].calls]


def test_skips_are_the_references():
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            assert get_config(arch).skip_reason(shape) == ref_get_config(arch).skip_reason(shape)


# full-size pairs: (arch, shape, unit) on the single-pod layout
FULL = [("granite_20b", "train_4k", "train_step"), ("mixtral_8x7b", "decode_32k", "serve_step"),
        ("seamless_m4t_medium", "prefill_32k", "prefill"),
        ("rwkv6_1p6b", "long_500k", "serve_step")]


@pytest.mark.parametrize("arch,shape,unit", FULL, ids=[f"{a}-{s}" for a, s, _ in FULL])
def test_full_size_pairs_run_ok(tmp_path, arch, shape, unit):
    """One rank of (16, 16) at full size: granite-20b's 52 layers at
    ``train_4k`` (the per-leaf exchange over the pod's 256 ranks),
    mixtral's ``decode_32k``, seamless-m4t's ``prefill_32k`` and rwkv6's
    ``long_500k``: ``ok``, with memory, roofline terms and collectives,
    and the record on disk."""
    rec = dryrun.run_pair(arch, shape, False, out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config(arch)
    on_disk = json.loads((tmp_path / f"{cfg.name}__{shape}__single.json").read_text())
    assert on_disk["status"] == "ok" and "traceback" not in on_disk
    assert rec["unit"] == unit
    mem, rf = rec["memory"], rec["roofline"]
    assert 0 < mem["argument_bytes"] and 0 < mem["output_bytes"] <= mem["temp_bytes"]
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0 and rf["collective_s"] > 0
    assert rf["model_flops"] == roofline.model_flops_for(cfg, INPUT_SHAPES[shape],
                                                         INPUT_SHAPES[shape]["kind"])
    assert rec["collectives"].get("all-gather", 0) > 0
    if unit == "train_step":  # the per-leaf exchange: a mean a leaf and the loss's
        assert rec["n_clients"] == 1 and rec["collectives"]["all-to-all"] > 0
        assert rec["kernels"] == {"f32_mean_xla": {"launches": 14, "bytes": 639_392}}
    else:
        assert rec["kernels"] == {}


def test_cli_prints_skips_and_writes_ok_records(tmp_path, capsys):
    dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "0 ok / 1 skip / 0 error" in out
    assert get_config("qwen15_4b").skip_reason("long_500k") in out
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--out-dir", str(tmp_path)])
    assert "1 ok / 0 skip / 0 error" in capsys.readouterr().out
    rec = json.loads((tmp_path / "gemma3-1b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["unit"] == "serve_step"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "generated_code_bytes"}


def test_roofline_terms_follow_the_datasheet():
    c = roofline.StepCounter()
    with c:
        a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
        b = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
        (a @ b).float() @ torch.empty((16, 8), device="meta")
    assert c.flops == {"bfloat16": 2 * 64 * 32 * 16, "float32": 2 * 64 * 16 * 8}
    assert c.compute_s() == 2 * 64 * 32 * 16 / 989e12 + 2 * 64 * 16 * 8 / 67e12
    stats = roofline.collective_stats(
        [dict(kind="all-reduce", bytes=100, members=[0, 1, 2, 3]),
         dict(kind="all-gather", bytes=80, members=[0, 4]),
         dict(kind="all-to-all", bytes=10, members=[5])], pod_groups=[[0, 4]])
    assert stats.total_bytes == 100 * 1.5 + 80 * 0.5 and stats.pod_bytes == 40
    rf = roofline.analyze(c, stats, n_devices=8, model_flops=1.0)
    assert rf.collective_s == 150 / 450e9 + 40 / 50e9
    assert rf.memory_s == c.bytes / 3.35e12
    assert dataclasses.asdict(rf)["coll"]["count"] == 2


def test_an_untied_head_prefills_across_ranks():
    """``make_dist_prefill`` of a config whose head is not its embedding
    (qwen1.5): the prefill returns the hidden state and reads no head, the
    one leaf it may leave unread (the dry run of qwen1.5-4b's
    ``prefill_32k`` found the check refusing it)."""
    from repro_torch.launch.dist import make_dist_prefill

    cfg = reduced(get_config("qwen15_4b"))
    assert not cfg.tie_embeddings
    fns = make_dist_prefill(cfg, device="cpu", mesh_shape={"data": 1, "model": 1})
    params = fns.init_params(torch.Generator().manual_seed(0))
    hidden, _ = fns.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int64)})
    assert tuple(hidden.shape) == (2, 8, cfg.d_model) and torch.isfinite(hidden).all()
