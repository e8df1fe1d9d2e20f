"""The run surface's verbs on every backend against the JAX package's, on
the CPU (mirrors the run-surface tests of ``tests/test_run_api.py``,
lines 89-133): ``init``, ``step``, ``evaluate``,
``checkpoint``, ``params_of`` and ``ledger`` on local, fed and gspmd.

Inputs: the reference's initial parameters and its held-out batch, handed
across as numpy.  Tolerances: ``evaluate``'s loss within ``rtol=1e-5``
(forward passes of two frameworks differ in their last ulps); a GSPMD
checkpoint file is compared key by key, shape and dtype, and, written
from the reference's own checkpoint read into the port's state, value by
value bit for bit.  Two gloo ranks (one a client, then one a device)
show that ``checkpoint`` and ``evaluate`` are collectives that rank 0
alone writes from.

Run as a script, the file is one of those ranks:
``python tests/test_torch_run_surface.py <rank> <store> <out>``.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_helpers import torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SPEC = dict(preset="tiny", rounds=1, batch=4, seq_len=16, clients=2, sparsity=0.05)
BACKENDS = {"local": dict(backend="local"), "fed": dict(backend="fed"),
            "gspmd": dict(backend="gspmd"),
            "gspmd-hist": dict(backend="gspmd", fast=True, flat_engine="hist"),
            # Adam's (m, v) state: LeNet5's optimizer
            "gspmd-adam": dict(backend="gspmd", preset="lenet5", fast=True, flat_engine="hist")}
ENGINES = {"leaf": {}, "hist": dict(fast=True, flat_engine="hist")}
LAYOUTS = {"clients": None, "devices": {"data": 1, "model": 2}}


def _torch_batch(batch: dict) -> dict:
    import torch

    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())
    return out


@functools.lru_cache(maxsize=None)
def ref_run(be: str):
    """The reference's run of ``SPEC`` on backend ``be``, built once."""
    from repro.run import RunSpec as JRunSpec
    from repro.run import build_run as j_build_run

    return j_build_run(JRunSpec(**{**SPEC, **BACKENDS[be]}))


def _with_params(be: str, state, params):
    if be == "local":
        return state._replace(params=params)
    if be == "fed":
        state.server.params = params
        return state
    return {**state, "params": params}


@pytest.mark.parametrize("be", ["local", "fed", "gspmd", "gspmd-hist"])
def test_evaluate_is_the_references(be):
    """The same params and the same held-out draw ``(0, n_clients + 1)``:
    the same loss; gspmd counts its layout's clients (one here), not
    ``spec.clients``."""
    import jax

    from repro_torch.convert import params_from_jax
    from repro_torch.run import RunSpec, build_run

    jrun = ref_run(be)
    trun = build_run(RunSpec(**{**SPEC, **BACKENDS[be]}), device="cpu")
    jstate, tstate = jrun.init(), trun.init()
    jparams = jrun.params_of(jstate)
    tstate = _with_params(be, tstate,
                          params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    draws = {"ref": [], "port": []}
    ref_sample = jrun.task.sample

    def j_sample(s, c):
        draws["ref"].append((s, c))
        return ref_sample(s, c)

    def t_sample(s, c):
        draws["port"].append((s, c))
        return _torch_batch(ref_sample(s, c))

    task = jrun.task
    jrun.task = dataclasses.replace(task, sample=j_sample)
    trun.task = dataclasses.replace(trun.task, sample=t_sample)
    try:
        want = jrun.evaluate(jstate)["loss"]
    finally:
        jrun.task = task
    got = trun.evaluate(tstate)["loss"]
    assert draws["port"] == draws["ref"] == [(0, jrun.n_clients + 1 if be.startswith("gspmd")
                                              else SPEC["clients"] + 1)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("be", list(BACKENDS))
def test_init_step_evaluate_checkpoint(be, tmp_path):
    import torch

    from repro_torch.checkpoint.io import load_pytree, restore_train_state
    from repro_torch.core import CommChannel
    from repro_torch.run import Run, RunSpec, build_run

    run = build_run(RunSpec(**{**SPEC, **BACKENDS[be]}), device="cpu")
    assert isinstance(run, Run)
    state = run.init()
    assert isinstance(run.channel, CommChannel)
    state, m = run.step(state, 0)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(run.evaluate(state)["loss"])
    path = str(tmp_path / "ckpt.npz")
    run.checkpoint(state, path)
    params = run.params_of(state)
    if be == "local":
        back = restore_train_state(path, state)
        for a, b in zip(_leaves(back.params), _leaves(params)):
            assert torch.equal(a, b)
    elif be == "fed":
        assert len(run.ledger.records) == 1
        assert run.restore(path)["rounds_done"] is None
    else:
        back = load_pytree(path, like=state)
        for a, b in zip(_leaves(back), _leaves(state)):
            assert torch.equal(a, b)


def _leaves(tree) -> list:
    """A tree's tensors in key order, through dicts, NamedTuples (Adam's
    state), tuples and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("be", ["gspmd", "gspmd-adam"])
def test_gspmd_checkpoint_is_the_references_file(be, tmp_path):
    """The port reads the reference's GSPMD checkpoint after a round into
    its own state and writes it back: every key, shape, dtype and value
    equal (per leaf, momentum: the residual a tree of (C,) + shape; flat
    hist, LeNet5's Adam: one (C, shards, n_pad) buffer, Adam's m and v as
    the reference names them)."""
    import jax

    from repro_torch.checkpoint.io import load_pytree
    from repro_torch.run import RunSpec, build_run

    jrun = ref_run(be)
    jstate, _ = jrun.step(jrun.init(), 0)
    jrun.checkpoint(jax.block_until_ready(jstate), str(tmp_path / "ref.npz"))
    trun = build_run(RunSpec(**{**SPEC, **BACKENDS[be]}), device="cpu")
    tstate = load_pytree(str(tmp_path / "ref.npz"), like=trun.init())
    trun.checkpoint(tstate, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "ref.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert any(k.startswith("residual") for k in got.files)
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the restored state steps on
    tstate, m = trun.step(tstate, 1)
    assert np.isfinite(float(m["loss"]))


# ------------------------------------------------------- the smaller names


def test_the_smaller_names_are_the_references(tmp_path, capsys):
    """``lr_schedule``'s decay (the reference's f32 product), ``scan_trips_for``,
    ``Task.sample_many`` (per-pair draws stacked), ``finish_run``'s
    ``print_summary`` and ``Tracer.write_chrome``."""
    import json

    import torch

    from repro.launch.dryrun import scan_trips_for as j_scan_trips_for
    from repro.run.build import lr_schedule as j_lr_schedule
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_lm_task
    from repro_torch.launch.dryrun import scan_trips_for
    from repro_torch.obs import finish_run, make_telemetry
    from repro_torch.run.build import lr_schedule

    for args in ((0.05,), (0.1, (2, 4)), (0.05, (1, 2, 3), 0.3)):
        want, got = j_lr_schedule(*args), lr_schedule(*args)
        assert [np.float32(got(i)) for i in range(6)] == \
            [np.float32(want(i)) for i in range(6)], args
    for arch in ("lenet5", "charlstm", "granite-20b", "jamba-v0.1-52b"):
        from repro.configs.base import get_config as j_get_config

        assert scan_trips_for(get_config(arch)) == j_scan_trips_for(j_get_config(arch)), arch
    task = make_lm_task(vocab=11, batch=2, seq_len=5, device="cpu")
    many = task.sample_many([1, 2, 1], [0, 3, 2])
    for i, (s, c) in enumerate([(1, 0), (2, 3), (1, 2)]):
        one = task.sample(s, c)
        assert all(torch.equal(many[k][i], one[k]) for k in one)
    tel = make_telemetry()
    with tel.span("round", round=0):
        tel.metrics.gauge("train/loss", 1.0, round=0)
    capsys.readouterr()
    finish_run(tel, print_summary=False)
    assert capsys.readouterr().out == ""
    finish_run(tel)
    assert capsys.readouterr().out
    path = tel.tracer.write_chrome(str(tmp_path / "trace.json"))
    assert [e["name"] for e in json.load(open(path))["traceEvents"]] == ["round"]


# ------------------------------------------------------------ two gloo ranks


def rank_main(rank: int, store: str, out: str) -> None:
    """One of two gloo ranks, on each layout (two clients, then one client
    of two devices): a round of each engine, then ``evaluate`` and
    ``checkpoint`` (each a collective) to a file named for this rank, and
    this rank's own view of the state to compare with."""
    import torch

    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.run import RunSpec, build_run

    torch.set_num_threads(1)
    group = ClientGroup.connect(rank=rank, world=2, device="cpu",
                                init_method=f"file://{store}")
    for case, layout in LAYOUTS.items():
        mine = {}
        for engine, kw in ENGINES.items():
            run = build_run(RunSpec(**{**SPEC, "backend": "gspmd", **kw}), device="cpu",
                            group=group, mesh_shape=layout)
            state, _ = run.step(run.init(), 0)
            mine[engine] = {
                "loss": run.evaluate(state)["loss"],
                "params": run.fns.params_to_tree(state["params"]),
                "residual": (state["residual"] if run.fns.residual_to_tree is None
                             else run.fns.residual_to_tree(state["residual"])),
                "flat": state["residual"] if run.fns.flat_space is not None else None,
            }
            run.checkpoint(state, f"{out}/{case}-{engine}.rank{rank}.npz")
        torch.save(mine, f"{out}/{case}-mine.rank{rank}.pt")
    group.close()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The directory the two ranks of :func:`rank_main` wrote to."""
    from torch_dist_cases import _env, finish, spawn

    out = tmp_path_factory.mktemp("two_ranks")
    procs = [spawn([sys.executable, str(Path(__file__).resolve()), str(r),
                    str(out / "store"), str(out)], out / f"rank{r}.log", _env(wait_s=120))
             for r in range(2)]
    finish(procs, timeout=240)
    return out


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_two_ranks_checkpoint_from_rank0_alone(case, two_ranks):
    import torch

    from repro_torch.checkpoint.io import load_pytree
    from repro_torch.run import RunSpec, build_run

    mine = [torch.load(two_ranks / f"{case}-mine.rank{r}.pt") for r in range(2)]
    for engine, kw in ENGINES.items():
        assert (two_ranks / f"{case}-{engine}.rank0.npz").exists()
        assert not (two_ranks / f"{case}-{engine}.rank1.npz").exists()
        assert mine[0][engine]["loss"] == mine[1][engine]["loss"]
        # the file restores into a one-rank run of the same layout's state
        one = build_run(RunSpec(**{**SPEC, "backend": "gspmd", **kw}), device="cpu",
                        mesh_shape=LAYOUTS[case])
        like = one.init()
        if case == "clients":  # two clients' rows
            like = {"params": like["params"],
                    **{k: _rows2(like[k]) for k in ("opt", "residual")}}
        back = load_pytree(str(two_ranks / f"{case}-{engine}.rank0.npz"), like=like)
        for a, b in zip(_leaves(back["params"]), _leaves(mine[0][engine]["params"])):
            assert torch.equal(a, b)
        if case == "devices":  # one client of two devices: the one-rank run's loss
            state = {**like, "params": back["params"]}
            np.testing.assert_allclose(mine[0][engine]["loss"],
                                       one.evaluate(state)["loss"], rtol=1e-5)
        for r in range(2):
            if engine == "hist":  # flat (C, shards, n_pad): a rank's row or device
                row = (back["residual"][r] if case == "clients"
                       else back["residual"][0, r])
                assert torch.equal(row, mine[r][engine]["flat"].reshape(row.shape))
            elif case == "clients":
                for a, b in zip(_leaves(back["residual"]), _leaves(mine[r][engine]["residual"])):
                    assert torch.equal(a[r], b[0])
            else:
                for a, b in zip(_leaves(back["residual"]), _leaves(mine[r][engine]["residual"])):
                    assert torch.equal(a, b)


def _rows2(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda v: v.expand((2,) + tuple(v.shape[1:])).clone(), tree)


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
