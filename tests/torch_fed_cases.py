"""Shared set-up of the fed backend's parity tests (``test_torch_fed_*.py``).

torch cannot draw JAX's threefry numbers, so everything random is made
with numpy and handed to both packages: each client's batches (a numpy
task keyed by (step, client), given to both pools), the initial
parameters (the reference's, carried across) and a warm optimizer state
or a seeded residual, imported into both pools.  Cohorts, staleness draws
and fault damage are numpy in both packages and need no handing across.

The reference's cohort step runs without its outer ``jit``
(:func:`unjitted`), as the local backend's tests call its channel outside
the trainer's ``jit``: under it XLA may fuse the survivors' gather into
μ's reduce and sum it in another order (ROADMAP C), which the port does
not reproduce.  ``jax.disable_jit()`` would go too far: it also turns off
``jnp.mean``'s own ``jit``, and op by op XLA divides the sum by k where
the jitted mean (and the port) multiplies it by the f32 1/k, one ulp
apart at some k.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.synthetic import Task as JTask
from repro.optim.optimizers import AdamState as JAdamState
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_flatten
from repro_torch.data.synthetic import Task as TTask
from repro_torch.optim.optimizers import AdamState
from repro_torch.run import RunSpec, build_run
from repro_torch.serve import DeltaLog
from torch_helpers import n

LENET = dict(preset="lenet5", backend="fed", batch=16, sparsity=0.01)
CHARLSTM = dict(preset="charlstm", backend="fed", batch=2, seq_len=16, sparsity=0.01)


def np_batch(preset: str, batch: int, seq_len: int, step: int, client: int) -> dict:
    rng = np.random.default_rng([step, client, 17])
    vocab = {"charlstm": 98, "tiny": 97, "fed-tiny": 256}.get(preset)
    if vocab:
        toks = rng.integers(0, vocab, (batch, seq_len + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return {"images": rng.standard_normal((batch, 28, 28, 1)).astype(np.float32),
            "labels": rng.integers(0, 10, (batch,)).astype(np.int32)}


def tasks(spec: dict) -> tuple:
    """The same numpy batches as a reference task and a port task."""
    kw = (spec["preset"], spec["batch"], spec.get("seq_len", 64))
    jtask = JTask(name="np", sample=lambda s, c: jax.tree.map(jnp.asarray, np_batch(*kw, s, c)))
    ttask = TTask(name="np", sample=lambda s, c: {
        k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
        for k, v in np_batch(*kw, s, c).items()})
    return jtask, ttask


def seeded_state(jstate: dict, warm_adam: bool, residual: bool, seed: int = 42) -> dict:
    """The reference pool's exported state with a warm Adam state (from
    zero moments |ΔW| ≈ lr everywhere in round 1 and the side SBC keeps is
    rounding noise, ROADMAP C) and/or a seeded residual."""
    rng = np.random.default_rng(seed)
    draw = lambda x, scale: (scale * rng.standard_normal(np.shape(x))).astype(np.float32)
    out = dict(jstate)
    if warm_adam:
        m = jax.tree.map(lambda x: draw(x, 0.01), jstate["opt"].m)
        v = jax.tree.map(lambda x: draw(x, 0.01) ** 2, jstate["opt"].v)
        out["opt"] = JAdamState(m, v)
    if residual:
        out["residual"] = jax.tree.map(lambda x: draw(x, 0.01), jstate["residual"])
    return out


def port_state(np_state: dict, tstate: dict) -> dict:
    """A reference pool state for the port's pool: the same arrays, the
    port's own per-client seeds (only stochastic codecs read them)."""
    opt = np_state["opt"]
    if isinstance(opt, JAdamState):
        opt = AdamState(jax.tree.map(np.asarray, opt.m), jax.tree.map(np.asarray, opt.v))
    return {"opt": opt, "residual": jax.tree.map(np.asarray, np_state["residual"]),
            "rng": tstate["rng"], "step": np.asarray(np_state["step"], np.int64)}


def capture_uploads(sched) -> list:
    """Every round's uploads ``[(client, blob), ...]`` as the server gets
    them."""
    log: list = []
    receive = sched.server.receive

    def recorded(uploads, round_idx):
        log.append([(int(u.client_id), u.blob) for u in uploads])
        return receive(uploads, round_idx)

    sched.server.receive = recorded
    return log


def unjitted(sched) -> None:
    """Run the reference pool's cohort step (``ClientPool._group_step``)
    without its ``jit``; every jnp function inside keeps its own."""
    pool = sched.pool
    pool._group_step = functools.partial(type(pool)._group_step.__wrapped__, pool)


def paired(spec: dict, *, warm_adam: bool = False, residual: bool = False) -> tuple:
    """The reference's FedRun and the port's, built from one spec, with the
    reference's initial parameters, the numpy task and the seeded pool
    state in both.  Returns ``(jrun, jsched, trun, tsched)``."""
    jrun = j_build_run(JRunSpec(**spec))
    trun = build_run(RunSpec(**spec), device="cpu")
    jsched, tsched = jrun.init(), trun.init()
    unjitted(jsched)
    jsched.pool.task, tsched.pool.task = tasks(spec)
    params = jax.tree.map(np.asarray, jsched.server.params)
    tsched.server.params = params_from_jax(params, "cpu")
    tsched.server.estimate = params_from_jax(params, "cpu")
    if tsched.server.delta_log is not None:  # the log starts at the handed params too
        tsched.server.delta_log = DeltaLog(tsched.server.estimate,
                                           horizon=tsched.server.delta_log.horizon, device="cpu")
    if warm_adam or residual:
        np_state = seeded_state(jax.tree.map(np.asarray, jsched.pool.export_state()),
                                warm_adam, residual)
        jsched.pool.import_state(jax.tree.map(jnp.asarray, np_state))
        tsched.pool.import_state(port_state(np_state, tsched.pool.export_state()))
    return jrun, jsched, trun, tsched


def bits_equal(a, b, what: str = "") -> None:
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    view = {4: np.uint32, 8: np.uint64}[a.itemsize] if a.dtype.kind == "f" else a.dtype
    np.testing.assert_array_equal(a.view(view), b.view(view), err_msg=what)


def trees_bits_equal(port_tree, ref_tree, what: str = "") -> None:
    ref = jax.tree.leaves(ref_tree)
    got = tree_flatten(port_tree)[0]
    assert len(got) == len(ref), (what, len(got), len(ref))
    for i, (a, b) in enumerate(zip(got, ref)):
        bits_equal(a, b, f"{what} leaf {i}")
