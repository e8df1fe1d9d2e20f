"""Multi-client cases of the GSPMD backend, run by both packages.

The reference runs on N forced host devices (one process,
``XLA_FLAGS=--xla_force_host_platform_device_count=N``), its channel or
train step on a ``("data", "model")`` mesh of N x 1; the port runs on N
gloo ranks on the CPU, one client per rank
(``repro_torch.launch.mesh.ClientGroup``, a ``file://`` store).  The test
process makes every input with numpy from a seed (the initial parameters
with the reference's ``model.init``, handed across) and writes one npz;
each side writes its outputs, and the tests compare them.

    python tests/torch_dist_cases.py reference N IN OUT DEVICES
    python tests/torch_dist_cases.py port RANK N STORE IN OUT

Cases (names are keys of the dicts below):
  * ``EXCHANGES``: ``ShardedGspmdChannel.round_exchange`` on the same
    per-client deltas and residuals, two rounds (the residual carried
    over), each metered into the channel's ledger as ``GspmdRun.step``
    does (LeNet5 at ``img_size=12``, p = 0.01);
  * ``EQ1``: the static Eq. 1 bits of full-width presets;
  * ``RUNS``: three train steps from one carried-across state on the same
    batches, metered; CharLSTM through ``build_run``/``GspmdRun``;
  * ``GROUP``: ``pmean`` and ``all_gather`` of the collectives themselves;
  * ``SHARDED``: ``round_exchange`` per shard on the (2, 2, 2) layout
    ``("pod", "data", "model")`` of ``LAYOUT`` on 8 forced host devices,
    given deltas and no model (the reference's model does not trace on a
    mesh of several axes on this jax; its channel does): a reduced
    granite-20b widened until its largest leaves pass the 1 MiB that
    sharding needs (``WIDE``), in pod mode (2 clients of 4 shards, FSDP) or
    in data mode (4 clients of 2 shards); the port runs 2 or 4 ranks with
    ``mesh_shape=LAYOUT``.  ``make_inputs(..., sharded=mode)``.  With one
    rank a device (:func:`run_devices`) the port runs 8 ranks, each
    holding its device's block of every leaf, on the inputs of both modes
    at once, and :func:`client_rows` puts each client's row back together
    from its ranks, so the same checks read it:

    python tests/torch_dist_cases.py devices RANK STORE OUT IN_POD IN_DATA
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
P = 0.01
DENSE, SKIP = r"^f[12]b$", r"^c1$"
EXCHANGE_ROUNDS = 2
EXCHANGES = {
    "exact": dict(fast=True, flat_engine="exact"),
    "exact-pack": dict(fast=True, flat_engine="exact", device_pack=True),
    "exact-pack-dense-skip": dict(fast=True, flat_engine="exact", device_pack=True,
                                  dense_pattern=DENSE, skip_pattern=SKIP),
    "leaf-dense-skip": dict(fast=False, dense_pattern=DENSE, skip_pattern=SKIP),
    "leaf-bf16": dict(fast=False, residual_dtype="bfloat16"),
    "hist": dict(fast=True, flat_engine="hist"),
}
EQ1 = {
    "lenet5": dict(preset="lenet5", fast=True),
    "lenet5-dense": dict(preset="lenet5", fast=True, dense_pattern=DENSE),
    "lenet5-leaf-dense": dict(preset="lenet5", fast=False, dense_pattern=DENSE),
    "charlstm": dict(preset="charlstm", fast=True),
}
RUN_ROUNDS = 3
RUNS = {
    "lenet5-exact-pack": dict(preset="lenet5", fast=True, flat_engine="exact", device_pack=True),
    "lenet5-leaf": dict(preset="lenet5", fast=False, dense_pattern=DENSE),
    "charlstm-exact": dict(preset="charlstm", fast=True, flat_engine="exact",
                           device_pack=True),
}
LM = dict(batch=2, seq_len=8)  # CharLSTM's run size
LENET5_BATCH = 16
LAYOUT = {"pod": 2, "data": 2, "model": 2}
# a reduced granite-20b whose embedding and MLP stacks reach 1 MiB in bf16
WIDE = dict(d_model=256, d_ff=1024, vocab_size=2048, head_dim=64)
SHARDED = {
    "pod-exact": dict(mode="pod", fast=True, flat_engine="exact"),
    "pod-exact-pack": dict(mode="pod", fast=True, flat_engine="exact", device_pack=True),
    "pod-hist": dict(mode="pod", fast=True, flat_engine="hist"),
    "pod-leaf": dict(mode="pod", fast=False),
    "pod-leaf-bf16": dict(mode="pod", fast=False, dtype="bfloat16"),
    "data-exact-pack": dict(mode="data", fast=True, flat_engine="exact", device_pack=True),
    "data-hist": dict(mode="data", fast=True, flat_engine="hist"),
    "data-leaf": dict(mode="data", fast=False),
}
SHARDED_CLIENTS = {"pod": 2, "data": 4}


def sharded_cases(mode: str) -> list:
    return [name for name, case in SHARDED.items() if case["mode"] == mode]


# the cases of run_devices (one rank a device): every pod-mode case and
# data mode's exact engine with the device pack, in the reference's
# processes (its compiles for 8 devices are the costliest part of the run)
DEVICE_PARTS = {"pod": (("pod-exact", "pod-exact-pack", "pod-leaf"),
                        ("pod-hist", "pod-leaf-bf16")),
                "data": (("data-exact-pack",),)}
DEVICE_CASES = {mode: sum(parts, ()) for mode, parts in DEVICE_PARTS.items()}




def wide_granite(case: dict) -> dict:
    """The case's changes to either package's ``reduced(get_config(
    "granite_20b"))``: ``WIDE``, the mode (FSDP in pod mode, as the
    config's own; off in data mode, where "data" is a client axis), and the
    leaves and residual in ``case["dtype"]`` (a dtype name, default f32)."""
    return dict(**WIDE, client_mode=case["mode"], fsdp=case["mode"] == "pod",
                dtype=case.get("dtype", "float32"), residual_dtype=case.get("dtype", "float32"))


def _cfg_kw(case: dict) -> dict:
    return {"img_size": 12} if case.get("preset", "lenet5") == "lenet5" else {}


def _spec_kw(case: dict) -> dict:
    return {k: case[k] for k in ("fast", "dense_pattern", "skip_pattern") if k in case}


# ------------------------------------------------------------- the inputs


def make_inputs(path: Path, n: int, *, exchanges=(), runs=(), eq1=(), group=False,
                sharded: str = "", seed: int = 0) -> None:
    """Write every input of the named cases to ``path`` (an npz), made with
    numpy from ``seed``; the reference's ``model.init`` gives the initial
    parameters (in this process, on its one device)."""
    import dataclasses

    import jax

    from repro.configs.base import get_config
    from repro.models.model import build_model

    rng = np.random.default_rng(seed)
    arrays = {}
    meta = dict(n=n, exchanges=list(exchanges), runs=list(runs), eq1=list(eq1), group=group,
                sharded=sharded)

    def shapes(case):
        cfg = dataclasses.replace(get_config(case.get("preset", "lenet5")), **_cfg_kw(case))
        a = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(a)[0]
        return cfg, [("/".join(str(k.key) for k in p), tuple(v.shape)) for p, v in flat]

    for name in exchanges:
        _, leaves = shapes(EXCHANGES[name])
        for leaf, s in leaves:
            arrays[f"x/{name}/res/{leaf}"] = (1e-3 * rng.standard_normal((n,) + s)
                                              ).astype(np.float32)
            for r in range(EXCHANGE_ROUNDS):
                arrays[f"x/{name}/delta/{r}/{leaf}"] = (
                    1e-3 * rng.standard_normal((n,) + s)
                    * np.exp(rng.standard_normal((n,) + s))).astype(np.float32)
    for name in runs:
        case = RUNS[name]
        cfg, leaves = shapes(case)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        for (p, _), v in zip(leaves, jax.tree.leaves(params)):
            arrays[f"r/{name}/params/{p}"] = np.asarray(v)
        if cfg.local_opt == "adam":  # a warm Adam state (ROADMAP C: no μ± tie)
            for p, s in leaves:
                arrays[f"r/{name}/m/{p}"] = (0.01 * rng.standard_normal((n,) + s)
                                             ).astype(np.float32)
                arrays[f"r/{name}/v/{p}"] = ((0.01 * rng.standard_normal((n,) + s)) ** 2
                                             ).astype(np.float32)
        for r in range(RUN_ROUNDS):
            if case["preset"] == "lenet5":
                arrays[f"r/{name}/batch/{r}/images"] = rng.standard_normal(
                    (n, LENET5_BATCH, 12, 12, 1)).astype(np.float32)
                arrays[f"r/{name}/batch/{r}/labels"] = rng.integers(
                    0, 10, (n, LENET5_BATCH)).astype(np.int32)
            else:
                toks = rng.integers(0, 98, (n, LM["batch"], LM["seq_len"] + 1)
                                    ).astype(np.int32)
                arrays[f"r/{name}/batch/{r}/tokens"] = toks[..., :-1]
                arrays[f"r/{name}/batch/{r}/labels"] = toks[..., 1:]
    if sharded:
        from repro.configs.base import reduced

        kw = wide_granite(dict(mode=sharded))
        cfg = dataclasses.replace(reduced(get_config("granite_20b")), **{
            k: v for k, v in kw.items() if k not in ("dtype", "residual_dtype")})
        a = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
        for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
            leaf, shape = "/".join(str(k.key) for k in p), (n,) + tuple(v.shape)
            arrays[f"s/res/{leaf}"] = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
            # positions every client selects (0.5% of each leaf, a spike of
            # each client's own size), so the mean adds every client's μ at
            # them and its order of adds shows
            hot = rng.random(tuple(v.shape)) < 0.005
            for r in range(EXCHANGE_ROUNDS):
                spike = 0.05 * (1 + rng.random((n,) + (1,) * len(v.shape))) * hot
                arrays[f"s/delta/{r}/{leaf}"] = (
                    1e-3 * rng.standard_normal(shape)
                    * np.exp(rng.standard_normal(shape)) + spike).astype(np.float32)
    if group:
        x = rng.standard_normal((n, 64)).astype(np.float32) * np.float32(1e3)
        # columns whose sum depends on the order of the adds
        big = np.float32(1e8)
        orders = [[big, 1, -big, 1], [1, 1, big, -big], [big, -big, 1, 1],
                  [1, big, 1, -big], [-big, 1, big, 1]]
        for j, col in enumerate(orders):
            x[:, j] = np.asarray((col * n)[:n], np.float32)
        x[:, 5] = np.float32(1) / np.float32(3)
        arrays["g/x"] = x
        arrays["g/words"] = rng.integers(0, 2 ** 32, (n, 9), dtype=np.uint64).astype(np.uint32)
        arrays["g/pos"] = rng.integers(0, 2 ** 40, (n, 5)).astype(np.int64)
    np.savez(path, meta=np.array(json.dumps(meta)), **arrays)


def _load(path):
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        return meta, {k: z[k] for k in z.files if k != "meta"}


def _tree(arrays: dict, prefix: str, fn=lambda a: a) -> dict:
    """The nested dict under ``prefix`` ("a/b" keys → {"a": {"b": ...}})."""
    out: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = fn(v)
    return out


def _paths(tree, pre=""):
    """``"a/b"`` paths of a nested dict, in sorted-key (leaf) order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_paths(v, f"{pre}{k}/") if isinstance(v, dict) else [pre + k])
    return out


def _f32(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(a.dtype) == "bfloat16" else a


# ----------------------------------------------------------- the reference


def reference_main(n: int, inp: str, out: str, devices: int, only: str = "") -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PS

    from repro.configs.base import get_config
    from repro.core.api import Compressor
    from repro.core.channel import shard_map
    from repro.launch.dist import build_dist_train
    from repro.optim.optimizers import AdamState
    from repro.run import RunSpec
    from repro.run.build import as_policy, policy_from_spec

    meta, x = _load(inp)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
    res_out, info = {}, {}

    def build(case, full=False, measure=True):
        cfg = get_config(case.get("preset", "lenet5"))
        cfg = dataclasses.replace(cfg, **({} if full else _cfg_kw(case)))
        if case.get("residual_dtype") == "bfloat16":
            cfg = dataclasses.replace(cfg, residual_dtype=jnp.bfloat16)
        policy = policy_from_spec(RunSpec(compressor="sbc", **_spec_kw(case)))
        return build_dist_train(
            cfg, mesh, compressor="sbc", sparsity=P,
            policy=None if isinstance(policy, Compressor) else as_policy(policy),
            fast=True if case.get("fast") else None,
            flat_engine=case.get("flat_engine", "exact"), measure=measure,
            device_pack=case.get("device_pack", False))

    def put(prefix, tree):
        for path, v in zip(_paths(tree), jax.tree.leaves(tree)):
            res_out[f"{prefix}/{path}"] = _f32(v)

    for name in meta["exchanges"]:
        case = EXCHANGES[name]
        fns = build(case)
        ch = fns.channel
        res_tree = _tree(x, f"x/{name}/res", jnp.asarray)
        if ch.flat_space is not None:
            space = ch.flat_space
            leaves = jax.tree.leaves(res_tree)
            res = jnp.stack([space.flatten_local([v[c] for v in leaves])
                             for c in range(n)])[:, None]
        else:
            res = jax.tree.map(lambda v: v.astype(ch.residual_dtype), res_tree)
        specs = tuple(PS("data") for _ in jax.tree.leaves(res_tree))
        step = jax.jit(lambda res, d: ch.round_exchange(
            res, d, mesh=mesh, in_specs=specs, res_spec=PS("data", "model", None),
            need_own=True))
        for r in range(EXCHANGE_ROUNDS):
            out_r = step(res, _tree(x, f"x/{name}/delta/{r}", jnp.asarray))
            mean, res, own = out_r[:3]
            put(f"{name}/{r}/mean", mean)
            put(f"{name}/{r}/own", own)
            if ch.flat_space is not None:
                res_out[f"{name}/{r}/res"] = np.asarray(res)
            else:
                put(f"{name}/{r}/res", res)
            packed_nbits = None
            if case.get("device_pack"):
                res_out[f"{name}/{r}/words"] = np.asarray(out_r[3][0])
                res_out[f"{name}/{r}/nbits"] = np.asarray(out_r[3][1])
                packed_nbits = out_r[3][1]
            ch.record_round(r, own_client0=jax.tree.map(lambda o: o[0], own),
                            packed_nbits=packed_nbits)
        info[name] = dict(ledger=ch.ledger.history(), bits_per_client=fns.bits_per_client,
                          bits_dense=fns.bits_dense)

    for name in meta["eq1"]:
        fns = build(EQ1[name], full=True, measure=False)
        info[f"eq1/{name}"] = dict(bits_per_client=fns.bits_per_client,
                                   bits_dense=fns.bits_dense)

    for name in meta["runs"]:
        case = RUNS[name]
        fns = build(case)
        state = fns.init_state(jax.random.PRNGKey(0))
        state["params"] = _tree(x, f"r/{name}/params", jnp.asarray)
        if f"r/{name}/m/" + _paths(state["params"])[0] in x:
            state["opt"] = AdamState(_tree(x, f"r/{name}/m", jnp.asarray),
                                     _tree(x, f"r/{name}/v", jnp.asarray))
        losses = []
        for r in range(RUN_ROUNDS):
            state, m = fns.train_step(state, _tree(x, f"r/{name}/batch/{r}", jnp.asarray))
            losses.append(float(m["loss"]))
            fns.channel.record_round(r, own_client0=m.get("own_client0"),
                                     packed_nbits=m.get("packed_nbits"))
            put(f"{name}/{r}/own_client0", m["own_client0"])
        put(f"{name}/params", state["params"])
        info[name] = dict(losses=losses, ledger=fns.channel.ledger.history(),
                          bits_per_client=fns.bits_per_client)

    if meta["sharded"]:
        reference_sharded(meta["sharded"], x, res_out, info,
                          names=only.split(",") if only else None)

    if meta["group"]:
        for w in range(2, n + 1):
            sub = Mesh(np.asarray(jax.devices()[:w]).reshape(w), ("data",))
            fn = jax.jit(shard_map(lambda v: (jax.lax.psum(v, "data"), jax.lax.pmean(v, "data")),
                                   mesh=sub, in_specs=PS("data"),
                                   out_specs=(PS("data"), PS("data"))))
            psum, pmean = fn(jnp.asarray(x["g/x"][:w]))
            res_out[f"g/{w}/psum"] = np.asarray(psum)
            res_out[f"g/{w}/pmean"] = np.asarray(pmean)
        if n >= 4:
            # two client axes ("pod", "data") = (2, 2): one pmean and one
            # all_gather an axis, "pod" first, as the channel takes them
            sub = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))

            def two_axes(v):
                g = jax.lax.all_gather(jax.lax.all_gather(v, "pod"), "data")
                return jax.lax.pmean(jax.lax.pmean(v, "pod"), "data"), g.reshape(1, 4, -1)

            lead = PS(("pod", "data"))
            pmean, gathered = jax.jit(shard_map(two_axes, mesh=sub, in_specs=lead,
                                                out_specs=(lead, lead)))(jnp.asarray(x["g/x"][:4]))
            res_out["g/2x2/pmean"] = np.asarray(pmean)
            res_out["g/2x2/gathered"] = np.asarray(gathered)

    np.savez(out + ".npz", **res_out)
    Path(out + ".json").write_text(json.dumps(info))


def reference_sharded(mode: str, x: dict, res_out: dict, info: dict, names=None) -> None:
    """The reference's ``round_exchange`` per shard on ``LAYOUT`` (8 forced
    host devices), two rounds, each metered as ``GspmdRun.step`` does; the
    mode's cases, or ``names``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PS

    from repro.configs.base import get_config, reduced
    from repro.core.channel import shard_map
    from repro.launch.dist import _lead_spec, build_dist_train, client_topology
    from repro.models.model import build_model, make_param_specs

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(tuple(LAYOUT.values())), tuple(LAYOUT))
    for name in names or sharded_cases(mode):
        case = SHARDED[name]
        kw = wide_granite(case)
        kw.update(dtype=getattr(jnp, kw["dtype"]),
                  residual_dtype=getattr(jnp, kw["residual_dtype"]))
        cfg = dataclasses.replace(reduced(get_config("granite_20b")), **kw)
        fns = build_dist_train(cfg, mesh, compressor="sbc", sparsity=P, fast=case["fast"],
                               flat_engine=case.get("flat_engine", "exact"), measure=True,
                               device_pack=case.get("device_pack", False))
        ch = fns.channel
        a = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
        specs = jax.tree.leaves(make_param_specs(a, mesh, fsdp=cfg.fsdp, expert_parallel=True),
                                is_leaf=lambda v: isinstance(v, PS))
        _, client_axes = client_topology(cfg, mesh)
        lead = _lead_spec(client_axes)
        in_specs = tuple(PS(lead, *sp) for sp in specs)
        shard_axes = tuple(ax for ax in mesh.axis_names if ax not in client_axes)
        res_spec = PS(lead, _lead_spec(shard_axes), None)
        cast = lambda v: jnp.asarray(v).astype(cfg.residual_dtype)
        res_tree = _tree(x, "s/res", cast)
        if ch.flat_space is not None:
            space = ch.flat_space
            res = jax.jit(shard_map(
                lambda *ls: space.flatten_local([v[0] for v in ls])[None, None], mesh=mesh,
                in_specs=in_specs, out_specs=res_spec))(*jax.tree.leaves(res_tree))
        else:
            res = res_tree
        step = jax.jit(lambda res, d: ch.round_exchange(
            res, d, mesh=mesh, in_specs=in_specs, res_spec=res_spec, need_own=True))
        for r in range(EXCHANGE_ROUNDS):
            out_r = step(res, _tree(x, f"s/delta/{r}", cast))
            mean, res, own = out_r[:3]
            for what, tree in (("mean", mean), ("own", own)):
                for path, v in zip(_paths(tree), jax.tree.leaves(tree)):
                    res_out[f"{name}/{r}/{what}/{path}"] = _f32(v)
            if ch.flat_space is not None:
                res_out[f"{name}/{r}/res"] = np.asarray(res)
            else:
                for path, v in zip(_paths(res), jax.tree.leaves(res)):
                    res_out[f"{name}/{r}/res/{path}"] = _f32(v)
            packed_nbits = None
            if case.get("device_pack"):
                res_out[f"{name}/{r}/words"] = np.asarray(out_r[3][0])
                res_out[f"{name}/{r}/nbits"] = np.asarray(out_r[3][1])
                packed_nbits = out_r[3][1]
            ch.record_round(r, own_client0=jax.tree.map(lambda o: o[0], own),
                            packed_nbits=packed_nbits)
        info[name] = dict(ledger=ch.ledger.history(), bits_per_client=fns.bits_per_client,
                          bits_dense=fns.bits_dense,
                          n_shards=[gl.n_shards for gl in ch.leaves])


# ---------------------------------------------------------------- the port


def port_main(rank: int, n: int, store: str, inp: str, out: str) -> None:
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.convert import state_from_jax
    from repro_torch.core.api import Compressor
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.optim.optimizers import AdamState
    from repro_torch.run import RunSpec
    from repro_torch.run.build import as_policy, policy_from_spec

    torch.set_num_threads(1)
    meta, x = _load(inp)
    res_out, info = {}, {}

    def row(a):
        return torch.from_numpy(np.array(a[rank:rank + 1]))

    def put(prefix, tree):
        for path, v in zip(_paths(tree), tree_flatten(tree)[0]):
            res_out[f"{prefix}/{path}"] = v.detach().to(
                torch.float32 if v.is_floating_point() else v.dtype).numpy()

    def build(case, group, full=False, measure=True):
        cfg = dataclasses.replace(get_config(case.get("preset", "lenet5")),
                                  **({} if full else _cfg_kw(case)))
        if case.get("residual_dtype") == "bfloat16":
            cfg = dataclasses.replace(cfg, residual_dtype=torch.bfloat16)
        policy = policy_from_spec(RunSpec(compressor="sbc", **_spec_kw(case)))
        return build_dist_train(
            cfg, group=group, sparsity=P,
            policy=None if isinstance(policy, Compressor) else as_policy(policy),
            fast=True if case.get("fast") else None,
            flat_engine=case.get("flat_engine", "exact"), measure=measure,
            device_pack=case.get("device_pack", False))

    group = ClientGroup.connect(rank=rank, world=n, device="cpu", backend="gloo",
                                init_method=f"file://{store}", timeout=gloo_timeout())
    try:
        for name in meta["exchanges"]:
            case = EXCHANGES[name]
            fns = build(case, group)
            ch = fns.channel
            res_tree = _tree(x, f"x/{name}/res", row)
            if ch.flat_space is not None:
                res = ch.flat_space.flatten_local([v[0] for v in tree_flatten(res_tree)[0]]
                                                  )[None, None]
            else:
                res = tree_map(lambda v: v.to(ch.residual_dtype), res_tree)
            for r in range(EXCHANGE_ROUNDS):
                out_r = ch.round_exchange(res, _tree(x, f"x/{name}/delta/{r}", row),
                                          need_own=True)
                mean, res, own = out_r[:3]
                put(f"{name}/{r}/mean", mean)
                put(f"{name}/{r}/own", own)
                if ch.flat_space is not None:
                    res_out[f"{name}/{r}/res"] = res.numpy()
                else:
                    put(f"{name}/{r}/res", res)
                packed_nbits = None
                if case.get("device_pack"):
                    words, nbits = out_r[3]
                    res_out[f"{name}/{r}/words"] = words.view(torch.int32).numpy().view(
                        np.uint32)
                    res_out[f"{name}/{r}/nbits"] = nbits.numpy()
                    packed_nbits = group.all_gather_rows(nbits[0])
                if rank == 0:
                    ch.record_round(r, own_client0=tree_map(lambda o: o[0], own),
                                    packed_nbits=packed_nbits)
            info[name] = dict(ledger=ch.ledger.history(), bits_per_client=fns.bits_per_client,
                              bits_dense=fns.bits_dense)

        for name in meta["eq1"]:
            fns = build(EQ1[name], group, full=True, measure=False)
            info[f"eq1/{name}"] = dict(bits_per_client=fns.bits_per_client,
                                       bits_dense=fns.bits_dense)

        for name in meta["runs"]:
            case = RUNS[name]
            fns = build(case, group)
            # the reference's state of n clients (zero residuals in its
            # layout), and this rank's row of it
            zeros = fns.init_state(torch.Generator())["residual"]
            zeros = (np.zeros((n,) + tuple(zeros.shape[1:]), np.float32)
                     if isinstance(zeros, torch.Tensor) else
                     tree_map(lambda v: np.zeros((n,) + tuple(v.shape[1:]), np.float32), zeros))
            np_state = {"params": _tree(x, f"r/{name}/params"), "residual": zeros,
                        "opt": (AdamState(_tree(x, f"r/{name}/m"), _tree(x, f"r/{name}/v"))
                                if any(k.startswith(f"r/{name}/m/") for k in x) else ())}
            state = state_from_jax(np_state, "cpu", client=rank)
            losses = []
            for r in range(RUN_ROUNDS):
                batch = _tree(x, f"r/{name}/batch/{r}", row)
                if "labels" in batch:
                    batch["labels"] = batch["labels"].long()
                if "tokens" in batch:
                    batch["tokens"] = batch["tokens"].long()
                state, m = fns.train_step(state, batch)
                losses.append(float(m["loss"]))
                if rank == 0:
                    fns.channel.record_round(r, own_client0=m.get("own_client0"),
                                             packed_nbits=m.get("packed_nbits"))
                    put(f"{name}/{r}/own_client0", m["own_client0"])
            put(f"{name}/params", state["params"])
            info[name] = dict(losses=losses, ledger=fns.channel.ledger.history(),
                              bits_per_client=fns.bits_per_client)

        if meta["sharded"]:
            port_sharded(meta["sharded"], group, rank, x, res_out, info)

        if meta["group"]:
            xr = torch.from_numpy(x["g/x"][rank])
            res_out["g/pmean"] = group.pmean(xr).numpy()
            res_out["g/rows"] = group.all_gather_rows(xr).numpy()
            words = torch.from_numpy(x["g/words"][rank].view(np.int32)).view(torch.uint32)
            res_out["g/words"] = group.all_gather_rows(words).view(torch.int32).numpy().view(
                np.uint32)
            res_out["g/pos"] = group.all_gather_rows(torch.from_numpy(x["g/pos"][rank])).numpy()
            if n == 4:
                res_out["g/2x2/pmean"] = group.pmean(xr, (2, 2)).numpy()
                res_out["g/2x2/gathered"] = group.all_gather_rows(xr)[
                    group.gather_order((2, 2))].numpy()
    finally:
        group.close()
    np.savez(f"{out}.rank{rank}.npz", **res_out)
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(info))


def port_sharded(mode: str, group, rank: int, x: dict, res_out: dict, info: dict) -> None:
    """This rank's client through the port's ``round_exchange`` per shard
    with ``mesh_shape=LAYOUT``: every output in the reference's layout of
    one client (a leading axis of 1)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.launch.dist import build_dist_train

    for name in sharded_cases(mode):
        case = SHARDED[name]
        kw = wide_granite(case)
        kw.update(dtype=getattr(torch, kw["dtype"]),
                  residual_dtype=getattr(torch, kw["residual_dtype"]))
        cfg = dataclasses.replace(reduced(get_config("granite_20b")), **kw)
        fns = build_dist_train(cfg, group=group, sparsity=P, fast=case["fast"],
                               flat_engine=case.get("flat_engine", "exact"), measure=True,
                               device_pack=case.get("device_pack", False), mesh_shape=LAYOUT)
        ch = fns.channel
        cast = lambda a: torch.from_numpy(np.array(a[rank:rank + 1])).to(cfg.residual_dtype)
        res_tree = _tree(x, "s/res", cast)
        if ch.flat_space is not None:
            space = ch.flat_space
            res = space.flatten_local([v[0] for v in tree_flatten(res_tree)[0]]).reshape(
                1, space.shards_per_client, space.n_pad)
        else:
            res = res_tree
        for r in range(EXCHANGE_ROUNDS):
            out_r = ch.round_exchange(res, _tree(x, f"s/delta/{r}", cast), need_own=True)
            mean, res, own = out_r[:3]
            for what, tree in (("mean", mean), ("own", own)):
                for path, v in zip(_paths(tree), tree_flatten(tree)[0]):
                    res_out[f"{name}/{r}/{what}/{path}"] = v.to(torch.float32).numpy()
            if ch.flat_space is not None:
                res_out[f"{name}/{r}/res"] = res.numpy()
            else:
                for path, v in zip(_paths(res), tree_flatten(res)[0]):
                    res_out[f"{name}/{r}/res/{path}"] = v.to(torch.float32).numpy()
            packed_nbits = None
            if case.get("device_pack"):
                words, nbits = out_r[3]
                res_out[f"{name}/{r}/words"] = words.view(torch.int32).numpy().view(np.uint32)
                res_out[f"{name}/{r}/nbits"] = nbits.numpy()
                packed_nbits = group.all_gather_rows(nbits[0])
            if rank == 0:
                ch.record_round(r, own_client0=tree_map(lambda o: o[0], own),
                                packed_nbits=packed_nbits)
        info[name] = dict(ledger=ch.ledger.history(), bits_per_client=fns.bits_per_client,
                          bits_dense=fns.bits_dense,
                          n_shards=[gl.n_shards for gl in ch.leaves])


def port_devices_main(rank: int, store: str, out: str, inputs: list) -> None:
    """One rank a device of ``LAYOUT`` (8 gloo ranks): each mode's cases of
    ``SHARDED`` through ``round_exchange`` on this rank's device block of
    its client's row of the inputs (``inputs``: the pod mode's npz, then the
    data mode's), metered on rank 0 as ``GspmdRun.step`` meters; every
    output this device's block (a leading axis of 1, and of 1 device on
    the flat path)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.launch.shards import block_slices

    torch.set_num_threads(1)
    world = int(np.prod(list(LAYOUT.values())))
    group = ClientGroup.connect(rank=rank, world=world, device="cpu", backend="gloo",
                                init_method=f"file://{store}", timeout=gloo_timeout())
    res_out, info = {}, {}
    try:
        for mode, inp in zip(("pod", "data"), inputs):
            _, x = _load(inp)
            for name in DEVICE_CASES[mode]:
                case = SHARDED[name]
                kw = wide_granite(case)
                kw.update(dtype=getattr(torch, kw["dtype"]),
                          residual_dtype=getattr(torch, kw["residual_dtype"]))
                cfg = dataclasses.replace(reduced(get_config("granite_20b")), **kw)
                fns = build_dist_train(cfg, group=group, sparsity=P, fast=case["fast"],
                                       flat_engine=case.get("flat_engine", "exact"),
                                       measure=True, device_pack=case.get("device_pack", False),
                                       mesh_shape=LAYOUT)
                ch, ranks = fns.channel, fns.ranks
                blocks = {lb.path: lb for lb in fns.blocks}

                def tree_of(prefix):  # this device's block of its client's row, a leaf each
                    out = {}
                    for key, a in x.items():
                        if key.startswith(prefix + "/"):
                            lb, row = blocks[key[len(prefix) + 1:]], np.array(a[ranks.client])
                            idx = block_slices(row.shape, lb.grid, lb.dev_block[ranks.device])
                            out[key] = torch.from_numpy(np.ascontiguousarray(row[idx])[None]
                                                        ).to(cfg.residual_dtype)
                    return _tree(out, prefix)

                res = tree_of("s/res")
                if ch.flat_space is not None:
                    res = ch.flat_space.flatten_local(
                        [v[0] for v in tree_flatten(res)[0]])[None, None]
                for r in range(EXCHANGE_ROUNDS):
                    out_r = ch.round_exchange(res, tree_of(f"s/delta/{r}"), need_own=True)
                    mean, res, own = out_r[:3]
                    for what, tree in (("mean", mean), ("own", own)):
                        for path, v in zip(_paths(tree), tree_flatten(tree)[0]):
                            res_out[f"{name}/{r}/{what}/{path}"] = v.to(torch.float32).numpy()
                    if ch.flat_space is not None:
                        res_out[f"{name}/{r}/res"] = res.numpy()
                    else:
                        for path, v in zip(_paths(res), tree_flatten(res)[0]):
                            res_out[f"{name}/{r}/res/{path}"] = v.to(torch.float32).numpy()
                    packed_nbits = None
                    if case.get("device_pack"):
                        words, nbits = out_r[3]
                        res_out[f"{name}/{r}/words"] = words.view(torch.int32).numpy().view(
                            np.uint32)
                        res_out[f"{name}/{r}/nbits"] = nbits.numpy()
                        every = group.all_gather_rows(nbits[0, 0])
                        packed_nbits = every[list(ranks.world_order)].reshape(
                            ch.n_clients, ranks.devices, -1)
                    own0 = tree_map(lambda o: o[0], own)
                    if ranks.client == 0:  # client 0's blocks, whole, from its ranks
                        own0 = fns.params_to_tree(own0)
                    if rank == 0:
                        ch.record_round(r, own_client0=own0, packed_nbits=packed_nbits)
                info[name] = dict(ledger=ch.ledger.history(),
                                  bits_per_client=fns.bits_per_client,
                                  bits_dense=fns.bits_dense,
                                  n_shards=[gl.n_shards for gl in ch.leaves],
                                  client=ranks.client, device=ranks.device,
                                  exchange_world=ch.group.world,
                                  blocks={p: [list(lb.grid), list(lb.dev_block)]
                                          for p, lb in blocks.items()})
    finally:
        group.close()
    np.savez(f"{out}.rank{rank}.npz", **res_out)
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(info))


# --------------------------------------------------- running both sides


@contextlib.contextmanager
def recorded_calls(log: list):
    """Inside, every collective of a ``ClientGroup`` of this process (of
    more than one rank) appends ``[kind, shape, dtype, the group's global
    ranks]`` to ``log``: what ``repro_torch.launch.dryrun.RecordingGroup``
    records of the same call (:func:`call_keys`)."""
    from repro_torch.launch.mesh import ClientGroup

    gather, exchange = ClientGroup.gather_list, ClientGroup.exchange_rows

    def key(kind, t, group):
        return [kind, list(t.shape), str(t.dtype).replace("torch.", ""), list(group.members)]

    def gather_list(self, t):
        if self.backend is not None:
            log.append(key("all-gather", t, self))
        return gather(self, t)

    def exchange_rows(self, rows):
        if self.backend is not None:
            log.append(key("all-to-all", rows, self))
        return exchange(self, rows)

    ClientGroup.gather_list, ClientGroup.exchange_rows = gather_list, exchange_rows
    try:
        yield log
    finally:
        ClientGroup.gather_list, ClientGroup.exchange_rows = gather, exchange


def call_keys(calls: list) -> list:
    """A dry run's recorded calls as :func:`recorded_calls` writes them."""
    return [[c["kind"], c["shape"], c["dtype"], c["members"]] for c in calls]


# the environment variable that hands the workers the seconds a gloo rank
# may wait for the others: the caller's deadline for the whole run, so the
# deadline, not gloo's default of 120 s, decides when a slow run fails
WAIT_ENV = "REPRO_TORCH_GLOO_TIMEOUT_S"


def _env(wait_s: float = None) -> dict:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(SRC), str(HERE)]),
           "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    if wait_s is not None:
        env[WAIT_ENV] = str(float(wait_s))
    return env


def gloo_timeout():
    """The wait a worker's gloo group takes (:data:`WAIT_ENV`, else the
    port's default ``TIMEOUT``)."""
    import datetime

    from repro_torch.launch.mesh import TIMEOUT

    wait = os.environ.get(WAIT_ENV)
    return TIMEOUT if wait is None else datetime.timedelta(seconds=float(wait))


def spawn(args: list, log: Path, env: dict) -> subprocess.Popen:
    """A worker process whose output goes to the file ``log``, never to a
    pipe: a pipe that nobody reads while the worker runs stops the worker
    once it holds 64 KiB (an XLA compile slowed down by a loaded machine
    prints long warnings), and the run then outlives its deadline."""
    with open(log, "w") as out:
        p = subprocess.Popen(args, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
    p.log = Path(log)
    return p


def _tail(p: subprocess.Popen, n: int) -> str:
    """The last ``n`` characters a worker wrote."""
    log = getattr(p, "log", None)
    if log is not None:
        return log.read_text(errors="replace")[-n:]
    return p.stdout.read()[-n:] if p.stdout else ""


def start_reference(tmp: Path, inp: Path, n: int, tag: str = "ref",
                    devices: int = 0, only: tuple = ()) -> subprocess.Popen:
    """The reference's process on ``devices`` (default ``n``) forced host
    devices (``only``: these sharded cases of the input's mode)."""
    return spawn([sys.executable, str(Path(__file__).resolve()), "reference",
                  str(n), str(inp), str(tmp / tag), str(devices or n)]
                 + ([",".join(only)] if only else []), tmp / f"{tag}.log", _env())


def start_port(tmp: Path, inp: Path, n: int, tag: str = "port", wait_s: float = None) -> list:
    """The port's ``n`` gloo ranks, one process each, meeting at a
    ``file://`` store under ``tmp``; each waits ``wait_s`` seconds at most
    for the others (default ``TIMEOUT``)."""
    return [spawn([sys.executable, str(Path(__file__).resolve()), "port", str(r), str(n),
                   str(tmp / f"{tag}.store"), str(inp), str(tmp / tag)],
                  tmp / f"{tag}.rank{r}.log", _env(wait_s)) for r in range(n)]


def finish(procs: list, timeout: float) -> None:
    """Wait for every process within ``timeout`` seconds of wall clock;
    kill them all after it, or when one fails (the others would wait in
    a collective), and raise with the failing one's output (after the
    deadline, each killed process's last output)."""
    deadline = time.monotonic() + timeout
    pending = list(procs)
    try:
        while pending:
            for p in list(pending):
                if p.poll() is None:
                    continue
                pending.remove(p)
                if p.returncode != 0:
                    raise AssertionError(f"{' '.join(p.args[2:4])} exited {p.returncode}:\n"
                                         f"{_tail(p, 4000)}")
            if time.monotonic() > deadline:
                for p in pending:
                    p.kill()
                    p.wait()
                tails = "".join(f"\n--- {' '.join(p.args[2:4])}:\n{_tail(p, 1000)}"
                                for p in pending)
                raise AssertionError(f"{len(pending)} processes outlived {timeout:.0f} s{tails}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            if p.stdout:
                p.stdout.close()


def run_devices(tmp: Path, timeout: float = 300.0) -> tuple:
    """Both modes' ``SHARDED`` inputs, their two reference processes (8
    forced host devices each) and the port's 8 ranks of one device each,
    all at once within ``timeout`` seconds.  Returns ``({mode: (ref
    arrays, ref info)}, [per-rank arrays], [per-rank info])``."""
    inputs = []
    for mode in ("pod", "data"):
        inp = tmp / f"inputs-{mode}.npz"
        make_inputs(inp, SHARDED_CLIENTS[mode], sharded=mode)
        inputs.append(inp)
    world = int(np.prod(list(LAYOUT.values())))
    procs = [start_reference(tmp, inp, SHARDED_CLIENTS[mode], tag=f"ref-{mode}-{i}",
                             devices=world, only=part)
             for mode, inp in zip(("pod", "data"), inputs)
             for i, part in enumerate(DEVICE_PARTS[mode])]
    procs += [spawn([sys.executable, str(Path(__file__).resolve()), "devices", str(r),
                     str(tmp / "devices.store"), str(tmp / "devices")] + [str(i) for i in inputs],
                    tmp / f"devices.rank{r}.log", _env(timeout)) for r in range(world)]
    finish(procs, timeout)
    refs = {}
    for mode in ("pod", "data"):
        parts = [load_outputs(tmp, f"ref-{mode}-{i}") for i in range(len(DEVICE_PARTS[mode]))]
        refs[mode] = ({k: v for arrays, _ in parts for k, v in arrays.items()},
                      {k: v for _, info in parts for k, v in info.items()})
    return (refs,) + load_outputs(tmp, "devices", world)


def client_rows(name: str, n: int, ports: list, infos: list) -> list:
    """Each client's outputs of case ``name`` in the layout of one rank a
    client, from its ranks of one device each: a leaf put together from
    its blocks (every device holding a block holds it bit for bit), a flat
    buffer, words and ``nbits`` stacked in device order."""
    from repro_torch.launch.shards import block_slices

    out = []
    for c in range(n):
        ranks = sorted((r for r in range(len(ports)) if infos[r][name]["client"] == c),
                       key=lambda r: infos[r][name]["device"])
        assert [infos[r][name]["device"] for r in ranks] == list(range(len(ranks))), c
        row = {}
        for key in (k for k in ports[ranks[0]] if k.startswith(name + "/")):
            parts = [ports[r][key] for r in ranks]
            if key.endswith(("/res", "/words", "/nbits")):
                row[key] = np.concatenate(parts, axis=1)
                continue
            grid, dev_block = infos[ranks[0]][name]["blocks"][key.split("/", 3)[3]]
            local = parts[0].shape[1:]
            grid = tuple(grid) + (1,) * (len(local) - len(grid))
            full = np.empty((1,) + tuple(g * d for g, d in zip(grid, local)), parts[0].dtype)
            for d, b in enumerate(dev_block):
                idx = (slice(None),) + block_slices(full.shape[1:], grid, b)
                if d == dev_block.index(b):
                    full[idx] = parts[d]
                else:
                    np.testing.assert_array_equal(bits(parts[d]), bits(full[idx]),
                                                  err_msg=f"{key} block {b} on device {d}")
            row[key] = full
        out.append(row)
    return out


def load_outputs(tmp: Path, tag: str, ranks=None) -> tuple:
    """``(arrays, info)`` of the reference (``ranks=None``), or lists of
    them, one a rank."""
    if ranks is None:
        return dict(np.load(tmp / f"{tag}.npz")), json.loads((tmp / f"{tag}.json").read_text())
    return ([dict(np.load(tmp / f"{tag}.rank{r}.npz")) for r in range(ranks)],
            [json.loads((tmp / f"{tag}.rank{r}.json").read_text()) for r in range(ranks)])


def run_both(tmp: Path, n: int, timeout: float = 300.0, **cases) -> tuple:
    """Write the inputs of ``cases``, run the reference (one process) and
    the port (``n`` gloo ranks) at once within ``timeout`` seconds, and
    return ``(ref arrays, ref info, [per-rank arrays], [per-rank info])``.
    The sharded cases give the reference the 8 devices of ``LAYOUT``."""
    inp = tmp / "inputs.npz"
    make_inputs(inp, n, **cases)
    devices = int(np.prod(list(LAYOUT.values()))) if cases.get("sharded") else n
    finish([start_reference(tmp, inp, n, devices=devices)]
           + start_port(tmp, inp, n, wait_s=timeout), timeout)
    return load_outputs(tmp, "ref") + load_outputs(tmp, "port", n)


# ------------------------------------------------------------ the checks


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def check_rows(name: str, n: int, ref: dict, ports: list, rtol=None) -> int:
    """Every output of case ``name`` on every rank equals the reference's
    row of that client, bit for bit (or within ``rtol``); returns how many
    arrays were compared."""
    keys = sorted(k for k in ref if k.startswith(name + "/"))
    assert keys, f"no reference outputs for {name}"
    for r in range(n):
        assert sorted(k for k in ports[r] if k.startswith(name + "/")) == keys, r
        for k in keys:
            want, got = ref[k][r:r + 1], ports[r][k]
            assert got.shape == want.shape and got.dtype == want.dtype, (k, got.shape,
                                                                           want.shape)
            if rtol is None:
                np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                           err_msg=f"rank {r} {k}")
    return len(keys) * n


def check_hist(name: str, n: int, ref: dict, ports: list, rtol: float = 1e-6) -> None:
    """The hist engine within ``rtol``: the same survivors, each client's
    ΔW* within ``rtol`` of the reference's, the mean within ``rtol`` of
    Σ_c |ΔW*_c| / C (a sum of the clients' ±μ / C can cancel, so its error
    is relative to that sum, not to the mean), and the residual within
    ``2 · rtol · max |ΔW*|`` (``acc`` where no round selected it)."""
    for key in sorted(k for k in ref if k.startswith(name + "/") and "/own/" in k):
        mean_key, res_key = key.replace("/own/", "/mean/"), key.replace("/own/", "/res/")
        scale = np.abs(ref[key]).sum(0) / n
        for r in range(n):
            own, want = ports[r][key][0], ref[key][r]
            np.testing.assert_array_equal(own != 0, want != 0, err_msg=f"rank {r} {key}")
            np.testing.assert_allclose(own, want, rtol=rtol, atol=0, err_msg=f"rank {r} {key}")
            err = np.abs(ports[r][mean_key][0] - ref[mean_key][r])
            assert (err <= rtol * scale).all(), (r, mean_key, float(err.max()))
    # a residual entry moves by at most the μ errors of the rounds that
    # selected it: within 2·rtol·max|ΔW*| over both rounds
    for r in range(n):
        top = max(float(np.abs(ref[k][r]).max()) for k in ref
                  if k.startswith(name + "/") and "/own/" in k)
        for k in sorted(k for k in ref if k.startswith(name + "/") and k.endswith("/res")):
            err = np.abs(ports[r][k] - ref[k][r:r + 1])
            assert (err <= 2 * rtol * top).all(), (r, k, float(err.max()), top)


def check_same_on_every_rank(prefix: str, n: int, ports: list) -> None:
    """The outputs under ``prefix`` are the same on every rank, bit for bit
    (every client applies the same mean)."""
    keys = [k for k in ports[0] if k.startswith(prefix + "/")]
    assert keys
    for r in range(1, n):
        for k in keys:
            np.testing.assert_array_equal(bits(ports[r][k]), bits(ports[0][k]),
                                          err_msg=f"rank {r} {k}")


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]),
                       *sys.argv[6:7])
    elif sys.argv[1] == "devices":
        port_devices_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5:])
    else:
        port_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
