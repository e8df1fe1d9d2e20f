"""Serving across ranks (``make_dist_prefill``, ``make_dist_serve``,
``cache_specs``; ROADMAP A12, part 4) against the JAX package, on the CPU.

The reference runs its ``make_dist_prefill`` and ``make_dist_serve`` on 8
forced host devices laid out ("pod", "data", "model") = (2, 2, 2); the
port runs 8 gloo ranks, one a device, each holding its device's blocks of
the params (``Model.param_specs``) and of the caches (``cache_specs``)
and its ("pod", "data") rows (``tests/torch_serve_cases.py``).  Cases, the
reference's ``reduced`` configs, a prefill of 4 x 16 then 3 decode steps:
granite-20b (MQA: the cache's sequence over "model"; and at batch 2,
which does not divide over the 4 ("pod", "data") devices and is served
whole), mixtral-8x7b (KV heads over "model", the sliding window, the
MoE), jamba-v0.1 (Mamba's ``h`` and ``conv`` over their channels, an
attention layer, the MoE), rwkv6-1.6b (``s`` over heads, ``tm_prev`` and
``cm_prev`` over channels) and seamless-m4t-medium (``cross_k`` and
``cross_v`` over heads).  The one-rank port (``ServeEngine`` on the whole
params) runs in this process meanwhile.

Tolerances, the zoo's:
  * logits against the reference's ``rtol=1e-4, atol=1e-4``
    (``tests/test_torch_zoo_model.py``), against the one-rank port's
    ``rtol=1e-5, atol=1e-5``;
  * each rank's cache blocks against the reference's whole caches cut by
    the reference's ``cache_specs``, and each rank's rows of the prefill's
    hidden state against the reference's rows and the one-rank port's:
    ``rtol=1e-5, atol=1e-5``; ``pos`` equal.  But rwkv6's hidden rows
    against the reference's: ``rtol=1e-4`` beside ``atol=1e-5``
    (``tests/test_torch_ssm.py``'s bound through a recurrence's loop): the
    one-rank port's prefill, to which each rank's rows are equal bit for
    bit, is 1.73e-5 off the reference's at one of 4,096 entries (0.410031
    against 0.410026);
  * the greedy token of every step equal on every rank and to the
    reference's; the port's ``cache_specs`` equal to the reference's.

``cache_specs`` at full size, on the ``meta`` device, is held against
the reference's in ``tests/test_torch_param_specs.py``.  A world that is
not the layout's devices is refused, as the reference cannot make its
mesh.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import dist as tdist
from repro_torch.launch import dryrun
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine
from torch_dist_cases import _tree, call_keys
from torch_helpers import one_thread
from torch_serve_cases import CASES, LAYOUT, PROMPT, STEPS, WORLD, _batch, block, run_both

TOL = dict(rtol=1e-5, atol=1e-5)
REF_LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
REF_HIDDEN_TOL = {"rwkv6": dict(rtol=1e-4, atol=1e-5)}  # the recurrence's f32 noise


def one_rank(x: dict) -> dict:
    """``{case: (prefill hidden, [logits of each step])}`` of the one-rank
    port: the whole params, ``ServeEngine.serve_step`` after the model's
    prefill."""
    out = {}
    for name, case in CASES.items():
        model = build_model(reduced(get_config(case["arch"])))
        params = _tree(x, f"{name}/params", torch.from_numpy)
        batch = {k: torch.from_numpy(x[f"{name}/{k}"]) for k in ("tokens", "enc_frames")
                 if f"{name}/{k}" in x}
        batch["tokens"] = batch["tokens"].long()
        engine = ServeEngine(model)
        with torch.no_grad():
            hidden, caches = model.prefill(params, batch)
            steps = []
            for s in range(STEPS):
                tokens = torch.from_numpy(x[f"{name}/step{s}/tokens"]).long()
                logits, caches = engine.serve_step(params, tokens, caches, PROMPT + s)
                steps.append(logits.numpy())
        out[name] = hidden.numpy(), steps
    return out


def dry_runs(x: dict) -> dict:
    """``{case: [each rank's dry run]}``: its prefill and step-0 decode on
    the ``meta`` device (``repro_torch.launch.dryrun``) with a recording
    group of the layout in place of the ranks: the calls it records and its
    ``argument_bytes``."""
    out = {}
    for name, case in CASES.items():
        cfg = reduced(get_config(case["arch"]))
        batch = _batch(x, name, torch.from_numpy)
        batch["tokens"] = batch["tokens"].long()
        out[name] = []
        for r in range(WORLD):
            pf = dryrun.dry_prefill(cfg, LAYOUT, batch, rank=r)
            dc = dryrun.dry_decode(cfg, LAYOUT, batch=case["batch"], seq_len=PROMPT, pos=PROMPT,
                                   rank=r, tokens_dtype=torch.int64)
            out[name].append({"prefill": call_keys(pf["log"].calls),
                              "decode": call_keys(dc["log"].calls),
                              "prefill_args": pf["argument_bytes"],
                              "decode_args": dc["argument_bytes"]})
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``(inputs, ref arrays, ref info, [rank arrays], [rank info], (one
    rank's logits, the ranks' dry runs))``."""
    def during(x):
        with one_thread():
            return one_rank(x), dry_runs(x)

    return run_both(tmp_path_factory.mktemp("serve"), timeout=240.0, during=during)


def _cache_keys(ref: dict, name: str, stage: str) -> list:
    return [k for k in ref if k.startswith(f"{name}/{stage}/caches/")]


def _held(served, name: str, stage: str) -> int:
    """Hold every rank's cache blocks of ``stage`` against the reference's
    whole caches cut by its specs; returns the blocks compared."""
    _, ref, rinfo, ports, infos, _ = served
    count = 0
    for r in range(WORLD):
        coords = infos[r][name]["coords"]
        for key in _cache_keys(ref, name, stage):
            path = key.split("/caches/", 1)[1]
            want = block(ref[key], rinfo[name]["cache_specs"][path], coords)
            got = ports[r][key]
            assert got.shape == want.shape, (key, r)
            if path.endswith("pos"):
                np.testing.assert_array_equal(got, want, err_msg=f"{key} rank {r}")
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=f"{key} rank {r}")
            count += 1
    return count


def test_every_rank_is_one_device_of_the_layout(served):
    """Rank r is the device at r row-major over ("pod", "data", "model");
    its "model" group is its ("pod", "data") coordinate's 2 ranks, its
    batch group the 4 ranks of its "model" coordinate, and its rows that
    coordinate's share (all of them at batch 2); every case holds fewer
    params on a rank than the whole model."""
    x, _, _, _, infos, _ = served
    for r, info in enumerate(infos):
        pod, data, model = r // 4, (r // 2) % 2, r % 2
        for name, case in CASES.items():
            got = info[name]
            assert got["coords"] == {"pod": pod, "data": data, "model": model}
            assert got["model"] == [model, 2] and got["batch"] == [2 * pod + data, 4]
            n = case["batch"] // 4 if case["batch"] % 4 == 0 else case["batch"]
            first = (2 * pod + data) * n if case["batch"] % 4 == 0 else 0
            assert got["rows"] == [first, first + n], name
            whole = sum(v.size for k, v in x.items() if k.startswith(f"{name}/params/"))
            assert got["param_blocks"] < whole, name
    assert len(infos) == WORLD == int(np.prod(list(LAYOUT.values())))


@pytest.mark.parametrize("name", list(CASES))
def test_cache_specs_are_the_references(served, name):
    _, _, rinfo, _, infos, _ = served
    for info in infos:
        assert info[name]["cache_specs"] == rinfo[name]["cache_specs"]
    specs = rinfo[name]["cache_specs"]
    cut = [e for spec in specs.values() for e in spec if e == "model"]
    assert cut, f"{name}: no cache leaf is cut over 'model'"


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_rows_and_cache_blocks(served, name):
    _, ref, _, ports, infos, (one, _) = served
    for r in range(WORLD):
        a, b = infos[r][name]["rows"]
        got = ports[r][f"{name}/prefill/hidden"]
        np.testing.assert_allclose(got, one[name][0][a:b], **TOL, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(got, ref[f"{name}/prefill/hidden"][a:b],
                                   **REF_HIDDEN_TOL.get(name, TOL), err_msg=f"{name} rank {r}")
    assert _held(served, name, "prefill") == WORLD * len(_cache_keys(ref, name, "prefill"))


@pytest.mark.parametrize("name", list(CASES))
def test_decode_logits_and_cache_blocks_are_the_references(served, name):
    _, ref, _, ports, _, _ = served
    for s in range(STEPS):
        for r in range(WORLD):
            np.testing.assert_allclose(ports[r][f"{name}/step{s}/logits"],
                                       ref[f"{name}/step{s}/logits"], **REF_LOGITS_TOL,
                                       err_msg=f"{name} step {s} rank {r}")
        assert _held(served, name, f"step{s}") > 0


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_agree_on_every_rank_and_with_the_reference(served, name):
    _, ref, _, ports, _, _ = served
    for s in range(STEPS):
        want = np.argmax(ref[f"{name}/step{s}/logits"][:, -1], axis=-1)
        for r in range(WORLD):
            got = np.argmax(ports[r][f"{name}/step{s}/logits"][:, -1], axis=-1)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} step {s} rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_logits_are_the_one_rank_ports(served, name):
    _, _, _, ports, _, (one, _) = served
    for s in range(STEPS):
        for r in range(WORLD):
            np.testing.assert_allclose(ports[r][f"{name}/step{s}/logits"], one[name][1][s], **TOL,
                                       err_msg=f"{name} step {s} rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_the_dry_run_makes_each_ranks_calls_and_holds_its_bytes(served, name):
    """Each rank's collectives in the prefill and in every decode step,
    recorded on its gloo group, are those its dry run's recording group
    makes, in order (kind, shape, dtype, the group's ranks); the dry
    run's ``argument_bytes`` are the bytes of the rank's params, batch,
    tokens and caches."""
    _, _, _, _, infos, (_, dry) = served
    for r in range(WORLD):
        got, want = infos[r][name], dry[name][r]
        assert got["calls"]["prefill"] == want["prefill"], r
        assert want["prefill"] and want["decode"], r
        for s in range(STEPS):
            assert got["calls"]["steps"][s] == want["decode"], (r, s)
        assert got["args"] == {"prefill": want["prefill_args"], "decode": want["decode_args"]}, r


def test_a_world_that_is_not_the_layouts_devices_is_refused():
    """The port refuses a group of another size than the layout's devices,
    as the reference cannot make a mesh of more devices than it has."""
    cfg = reduced(get_config("granite_20b"))
    with pytest.raises(ValueError, match="one rank a device"):
        tdist.make_dist_serve(cfg, device="cpu", batch=2, seq_len=8,
                              mesh_shape={"data": 2, "model": 2})
    with pytest.raises(ValueError, match="one rank a device"):
        tdist.make_dist_prefill(cfg, device="cpu", mesh_shape={"data": 1, "model": 2})
    with pytest.raises(ValueError):
        jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:1])


@pytest.mark.parametrize("build", ["serve", "prefill"])
def test_entry_points_default_to_the_card(monkeypatch, build):
    """Both builders run on the card unless the caller passes
    ``device="cpu"``: without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("granite_20b"))
    call = {"serve": lambda **kw: tdist.make_dist_serve(cfg, batch=2, seq_len=8, **kw),
            "prefill": lambda **kw: tdist.make_dist_prefill(cfg, **kw)}[build]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()
    call(device="cpu")
