"""The train step with one rank a device against the same step with one
rank holding its client's devices, and one device's layout at full
depth against the JAX package, on the CPU.

Four gloo ranks run pod mode on ("data", "model") = (2, 2), one client of
four devices, a reduced granite-20b widened so that its embedding and
MLP stacks shard (``torch_dist_cases.WIDE``), f32, FSDP; two ranks run a
reduced mixtral on (2, 1).  The one-rank path runs the same cases in
this process on the same layout, init and batches
(``tests/torch_fsdp_cases.py``).  The two sum the pod's gradient in
another order (the ranks: a mean loss a "data" share, its gradient, then
the mean over the "data" ranks; one rank: the whole batch's mean loss),
so:

  * Eq. 1 bits, the state's shapes (each rank 1/S of a sharded leaf) and
    the gathered blocks cut again (every rank's, exactly): equal;
  * ``compressor="dense"``: losses within ``rtol=1e-6`` and the gathered
    params within ``rtol=1e-5, atol=1e-7`` (the gradients agree to a few
    f32 ulps; the params are of the order of 0.02, whose f32 ulp is about
    2e-9, and near zero the relative error means nothing);
  * SBC (exact with the device pack, hist, the per-leaf exchange under
    momentum): client 0's survivors equal but for swaps of a (segment,
    device, row)'s k-th entry, at most 2 entries a row a round, and the
    params within that tolerance elsewhere (``test_torch_charlstm_run.py``'s
    rule);
  * the MoE aux term of every layer within ``rtol=1e-6``, and the MoE
    cases' losses and params at the dense case's tolerance (two ranks on
    (2, 1): the reduced mixtral, grouped dispatch, and the reduced
    llama4-maverick, flat dispatch at a capacity factor of 0.5 so that
    pairs drop, whose capacity and slots are the pod batch's).

``chip_smoke.py``'s phase 16 pins its layouts to the reference's.  At
full depth, on the meta device: granite-20b and command-r-35b on
``production_layout()`` in their f32 variants give one device's padded
length under 2³¹ (the one-rank-a-client buffer of 256 devices is past
it) and equal to the reference's, with the reference's Eq. 1 bits
(``tests/test_torch_pod_run.py``'s ``reference_bits``).
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro_torch.configs.base import get_config
from repro_torch.kernels.flat import MAX_FLAT_ENTRIES
from repro_torch.launch import dryrun
from repro_torch.launch.dist import device_flat_space
from repro_torch.launch.mesh import production_layout
from test_torch_pod_run import _pin_cfg, reference_bits
from torch_dist_cases import call_keys, finish
from torch_fsdp_cases import CASES, LAYOUT, MOE, PEAK, case_cfg, load, run_case, start_ranks
from torch_helpers import load_chip_smoke, one_thread

GRANITE = [name for name in CASES if name not in MOE]
SBC = ("exact-pack", "hist", "leaf-momentum")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(one rank's {case: (arrays, info)}, 4 ranks' [...], 2 ranks' [...])``."""
    tmp = tmp_path_factory.mktemp("fsdp")
    procs = (start_ranks(tmp, 4, [PEAK] + GRANITE, "granite", wait_s=240.0)
             + start_ranks(tmp, 2, list(MOE), "moe", wait_s=240.0))
    try:
        with one_thread():
            one = {name: run_case(name) for name in CASES}
    finally:
        finish(procs, 240.0)
    return one, load(tmp, "granite", 4), load(tmp, "moe", 2)


def _ranks_of(runs, name):
    return runs[2] if name in MOE else runs[1]


@pytest.mark.parametrize("name", list(CASES))
def test_eq1_bits_and_losses_finite(runs, name):
    one = runs[0][name][1]
    for rank in _ranks_of(runs, name):
        assert rank[name][1]["bits"] == one["bits"], name
        assert np.isfinite(rank[name][1]["losses"]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_device_blocks(runs, name):
    """Params, optimizer rows and residual: 1/S of the client's for a
    sharded leaf (S its blocks), the flat residual one device's buffer;
    gathered and cut again, the params are every rank's blocks exactly."""
    one = runs[0][name][1]["shapes"]
    for rank in _ranks_of(runs, name):
        info = rank[name][1]
        got = info["shapes"]
        assert info["split_exact"], name
        for whole, block, s in zip(one["params"], got["params"], info["n_shards"]):
            assert math.prod(whole) == s * math.prod(block), (name, whole, block)
        assert len(got["opt"]) == len(one["opt"])
        for whole, block, s in zip(one["opt"], got["opt"], info["n_shards"] * 3):
            assert math.prod(whole) == s * math.prod(block), (name, whole, block)
        if CASES[name]["fast"]:  # (1, 1, n_pad) against (1, S, n_pad)
            assert got["residual"][0][:2] == [1, 1] and one["residual"][0][1] == 4
            assert got["residual"][0][2] == one["residual"][0][2]
        else:
            assert info["residual_whole"] == one["residual"]
            for whole, block, s in zip(one["residual"], got["residual"], info["n_shards"]):
                assert math.prod(whole) == s * math.prod(block)
        assert max(info["n_shards"]) == (2 if name in MOE else 4)


@pytest.mark.parametrize("name", list(CASES))
def test_the_dry_run_makes_each_ranks_calls_and_holds_its_bytes(runs, name):
    """Each rank's collectives in round 1's train step, recorded on its
    gloo group, are those of the dry run's recording group at that rank
    (``repro_torch.launch.dryrun.dry_train`` on the ``meta`` device, the
    case's build options): the same calls in the same order (kind, shape,
    dtype, the group's ranks); and its ``argument_bytes`` are the bytes of
    the rank's params, optimizer rows, residual and batch."""
    case = CASES[name]
    ranks = _ranks_of(runs, name)
    for r, rank in enumerate(ranks):
        info = rank[name][1]
        batch = {k: torch.empty(shape, dtype=getattr(torch, dt.replace("torch.", "")),
                                device="meta") for k, (shape, dt) in info["batch"].items()}
        got = dryrun.dry_train(case_cfg(case), case.get("layout", LAYOUT), batch, rank=r,
                               compressor=case.get("compressor", "sbc"), sparsity=0.01,
                               fast=case["fast"], flat_engine=case.get("flat_engine", "exact"),
                               measure=case.get("measure", False),
                               device_pack=case.get("device_pack", False))
        assert call_keys(got["log"].calls) == info["calls0"], (name, r)
        assert info["calls0"], name
        assert got["argument_bytes"] == info["args0"], (name, r)


def test_init_host_peak_is_a_ranks_blocks(runs):
    """``init_state`` on each of 4 ranks (granite widened to 0.3 GB of f32
    params, the flat path) cuts every leaf as the model draws it: the
    host's high-water mark over the init is the state it returns (this
    rank's quarter of the params and a quarter-size residual: half the
    model, and the flat buffer's padding) and at most one draw's whole
    tensors more, where drawing the whole model first peaked at 1.5 models
    (glibc's mmap threshold is fixed in the ranks, so that freed blocks
    leave the resident set)."""
    for rank in runs[1]:
        got = rank[PEAK][1]
        assert got["whole"] // 2 <= got["state"] <= 1.01 * got["whole"] // 2, got
        assert got["peak"] <= got["state"] + got["drawn"] + (16 << 20), got


def test_dense_params_and_loss_close(runs):
    arrays, info = runs[0]["dense"]
    for rank in runs[1]:
        got, ginfo = rank["dense"]
        np.testing.assert_allclose(ginfo["losses"], info["losses"], rtol=1e-6)
        assert sorted(got) == sorted(arrays) and arrays  # each rank gathers the whole params
        for k in arrays:
            np.testing.assert_allclose(got[k], arrays[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", SBC)
def test_sbc_same_survivors_but_kth_swaps(runs, name):
    arrays, info = runs[0][name]
    got = runs[1][0][name][0]  # rank 0 holds client 0's transmitted dW*
    rows = 0  # (segment, device, row)s a round: L rows a block of each leaf
    for k in (k for k in arrays if k.startswith("0/own/")):
        w = arrays[k]
        s = runs[1][0][name][1]["n_shards"][int(k.split("/")[-1])]
        rows += (w.shape[0] if w.ndim == 3 else 1) * s
    for r in range(2):
        keys = [k for k in arrays if k.startswith(f"{r}/own/")]
        assert keys and sorted(keys) == sorted(k for k in got if k.startswith(f"{r}/own/"))
        swapped = sum(int(((got[k] != 0) != (arrays[k] != 0)).sum()) for k in keys)
        assert swapped <= 2 * rows, (name, r, swapped, rows)
    off = sum(int((~np.isclose(got[k], arrays[k], rtol=1e-5, atol=1e-7)).sum())
              for k in arrays if k.startswith("1/params/"))
    assert off <= 2 * 2 * rows, (name, off)
    np.testing.assert_allclose(runs[1][0][name][1]["losses"], info["losses"], rtol=1e-6)


def test_moe_aux_within_rtol(runs):
    one = runs[0]["mixtral-aux"][1]["aux"]
    assert one
    for rank in runs[2]:
        got = rank["mixtral-aux"][1]["aux"][:len(one)]  # the forward's (then remat's)
        np.testing.assert_allclose(got, one, rtol=1e-6)


@pytest.mark.parametrize("name", MOE)
def test_moe_params_and_loss_close(runs, name):
    """The MoE cases' losses and gathered params after each round at the
    dense case's tolerance: the router's gradient through the aux term's
    "data" mean, and flat dispatch's capacity and slots over the pod's
    batch (llama4 at capacity factor 0.5 drops pairs), are the one-rank
    path's."""
    arrays, info = runs[0][name]
    for rank in runs[2]:
        got, ginfo = rank[name]
        np.testing.assert_allclose(ginfo["losses"], info["losses"], rtol=1e-6)
        assert sorted(got) == sorted(arrays) and arrays
        for k in arrays:
            np.testing.assert_allclose(got[k], arrays[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("preset", ["granite_20b", "command_r_35b"])
def test_full_depth_device_layout_on_meta(preset):
    """One rank a device of the production layout at full depth: one
    device's padded length under 2³¹ and the reference's, its Eq. 1 bits
    the reference's; drawn on the meta device."""
    layout = production_layout()
    cfg = dataclasses.replace(get_config(preset), dtype=torch.float32,
                              residual_dtype=torch.float32)
    jcfg = dataclasses.replace(j_get_config(preset), dtype=jnp.float32,
                               residual_dtype=jnp.float32)
    space = device_flat_space(cfg, layout, sparsity=0.001)
    want = reference_bits(jcfg, layout, 0.001, fast=True)
    assert space.shards_per_client == 1 and want["shards"] == 256
    assert space.n_pad == want["n_pad"] < MAX_FLAT_ENTRIES < 256 * space.n_pad
    assert space.bits_per_client() == want["eq1"]
    assert sum(s.global_size for s in space.segments) == want["params"]


@pytest.mark.parametrize("phase", ["a", "b"])
def test_chip_smoke_fsdp_pins_are_the_references(phase):
    """``chip_smoke.py``'s phase 16 pins: the reference's bits, params,
    leaves, rows and one device's padded length on the layout, and the
    port's one-device space the same."""
    chip = load_chip_smoke()
    pin = chip.FSDP_PINS[phase]
    want = reference_bits(_pin_cfg(pin), pin["layout"], pin["sparsity"], pin["fast"])
    for key in ("eq1", "params", "leaves", "rows", "n_pad", "shards"):
        assert pin[key] == want[key], (phase, key, pin[key], want[key])
    space = device_flat_space(chip.pod_cfg(phase), pin["layout"], sparsity=pin["sparsity"],
                              device=pin["shards"] - 1)
    assert (space.n_pad, space.bits_per_client()) == (pin["n_pad"], pin["eq1"])
