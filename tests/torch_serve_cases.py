"""Serving across ranks, run by both packages.

The reference runs ``make_dist_prefill`` and ``make_dist_serve`` on 8
forced host devices (one process,
``XLA_FLAGS=--xla_force_host_platform_device_count=8``) laid out ("pod",
"data", "model") = ``LAYOUT``; the port runs 8 gloo ranks on the CPU, one a
device, each holding its device's blocks of the params and caches, with
``mesh_shape=LAYOUT``.  The test process makes every input with numpy
from a seed (the parameters with the reference's ``model.init``, handed
across) and writes one npz; each side writes its outputs, and the tests
compare them.

    python tests/torch_serve_cases.py reference IN OUT
    python tests/torch_serve_cases.py port RANK STORE IN OUT

Each case (``CASES``) is a reference ``reduced`` config: a prefill of
``batch`` prompts of ``PROMPT`` tokens (seamless: as many encoder frames),
then ``STEPS`` decode steps at positions ``PROMPT``, ``PROMPT + 1``, ...,
each fed seeded tokens (the same on both sides), against caches of that
depth.  The reference writes its whole hidden state, logits and caches,
and its ``cache_specs`` of the decode caches; each port rank writes its
rows of the hidden state, the whole logits, its blocks of the caches and
its coordinates.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

from torch_dist_cases import (_env, _f32, _load, _paths, _tree, finish, gloo_timeout,
                              recorded_calls, spawn)

LAYOUT = {"pod": 2, "data": 2, "model": 2}
WORLD = 8
PROMPT, STEPS = 16, 3
CASES = {
    "granite": dict(arch="granite_20b", batch=4),  # MQA: the cache's sequence over "model"
    "granite-b2": dict(arch="granite_20b", batch=2),  # the batch does not divide: whole
    "mixtral": dict(arch="mixtral_8x7b", batch=4),  # KV heads over "model", window, MoE
    "jamba": dict(arch="jamba_v01_52b", batch=4),  # Mamba's h and conv, attention, MoE
    "rwkv6": dict(arch="rwkv6_1p6b", batch=4),  # s over heads, tm_prev/cm_prev channels
    "seamless": dict(arch="seamless_m4t_medium", batch=4),  # cross_k/cross_v over heads
}


def make_inputs(path: Path, seed: int = 0) -> None:
    """Every case's params (the reference's ``model.init`` at
    ``PRNGKey(0)``, in this process), prompts, encoder frames and decode
    tokens, made with numpy from ``seed``, to ``path`` (an npz)."""
    import jax

    from repro.configs.base import get_config, reduced
    from repro.models.model import build_model

    x = {}
    for i, (name, case) in enumerate(CASES.items()):
        cfg = reduced(get_config(case["arch"]))
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        for p, v in zip(_paths(params), jax.tree.leaves(params)):
            x[f"{name}/params/{p}"] = np.asarray(v)
        rng = np.random.default_rng([seed, i])
        B = case["batch"]
        x[f"{name}/tokens"] = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        if cfg.family == "encdec":
            x[f"{name}/enc_frames"] = rng.standard_normal((B, PROMPT, cfg.d_model)).astype(
                np.float32)
        for s in range(STEPS):
            x[f"{name}/step{s}/tokens"] = rng.integers(0, cfg.vocab_size, (B, 1)).astype(
                np.int32)
    np.savez(path, meta=json.dumps({"cases": list(CASES)}), **x)


def _batch(x: dict, name: str, fn) -> dict:
    return {k: fn(x[f"{name}/{k}"]) for k in ("tokens", "enc_frames") if f"{name}/{k}" in x}


def spec_json(spec) -> list:
    """A spec (a ``PartitionSpec`` or the port's tuple) as JSON: an entry
    a dim, None, an axis name or a list of them."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


# ----------------------------------------------------------- the reference


def reference_main(inp: str, out: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec

    from repro.configs.base import get_config, reduced
    from repro.launch.dist import make_dist_prefill, make_dist_serve
    from repro.models.model import build_model

    _, x = _load(inp)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(tuple(LAYOUT.values())), tuple(LAYOUT))
    res, info = {}, {}

    def put(prefix, tree):
        for p, v in zip(_paths(tree), jax.tree.leaves(tree)):
            res[f"{prefix}/{p}"] = _f32(v)

    for name, case in CASES.items():
        cfg = reduced(get_config(case["arch"]))
        model = build_model(cfg)
        pf = make_dist_prefill(cfg, mesh, model=model)
        params = jax.device_put(_tree(x, f"{name}/params", jnp.asarray), pf.param_shardings)
        batch = _batch(x, name, jnp.asarray)
        hidden, caches = pf.prefill(params, jax.device_put(batch, pf.batch_shardings(batch)))
        res[f"{name}/prefill/hidden"] = _f32(hidden)
        put(f"{name}/prefill/caches", caches)
        sv = make_dist_serve(cfg, mesh, batch=case["batch"], seq_len=PROMPT, model=model)
        specs = jax.tree.map(lambda s: s.spec, sv.cache_shardings)
        info[name] = {"cache_specs": dict(zip(
            _paths(sv.abstract_caches),
            [spec_json(s) for s in jax.tree.leaves(
                specs, is_leaf=lambda s: isinstance(s, PartitionSpec))]))}
        caches = jax.device_put(caches, sv.cache_shardings)
        for s in range(STEPS):
            logits, caches = sv.serve_step(params, x[f"{name}/step{s}/tokens"], caches,
                                           jnp.int32(PROMPT + s))
            res[f"{name}/step{s}/logits"] = _f32(logits)
            put(f"{name}/step{s}/caches", caches)
    np.savez(f"{out}.npz", **res)
    Path(f"{out}.json").write_text(json.dumps(info))


# ------------------------------------------------------------------ the port


def port_main(rank: int, store: str, inp: str, out: str) -> None:
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.tree import tree_flatten
    from repro_torch.launch.dist import make_dist_prefill, make_dist_serve
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.models.model import build_model

    torch.set_num_threads(1)
    _, x = _load(inp)
    group = ClientGroup.connect(rank=rank, world=WORLD, device="cpu",
                                init_method=f"file://{store}", timeout=gloo_timeout())
    res, info = {}, {}

    def put(prefix, tree):
        for p, v in zip(_paths(tree), tree_flatten(tree)[0]):
            res[f"{prefix}/{p}"] = v.numpy()

    try:
        for name, case in CASES.items():
            cfg = reduced(get_config(case["arch"]))
            model = build_model(cfg)
            pf = make_dist_prefill(cfg, group=group, mesh_shape=LAYOUT, model=model)
            sv = make_dist_serve(cfg, group=group, batch=case["batch"], seq_len=PROMPT,
                                 mesh_shape=LAYOUT, model=model)
            params = sv.params_from_tree(_tree(x, f"{name}/params", torch.from_numpy))
            batch = _batch(x, name, torch.from_numpy)
            batch["tokens"] = batch["tokens"].long()
            calls = {"prefill": [], "steps": []}
            args = {"prefill": tree_bytes((params, batch))}
            with recorded_calls(calls["prefill"]):
                hidden, caches = pf.prefill(params, batch)
            res[f"{name}/prefill/hidden"] = hidden.numpy()
            put(f"{name}/prefill/caches", caches)
            for s in range(STEPS):
                tokens = torch.from_numpy(x[f"{name}/step{s}/tokens"]).long()
                if s == 0:
                    args["decode"] = tree_bytes((params, tokens, caches))
                with recorded_calls([]) as step_calls:
                    logits, caches = sv.serve_step(params, tokens, caches, PROMPT + s)
                calls["steps"].append(step_calls)
                res[f"{name}/step{s}/logits"] = logits.numpy()
                put(f"{name}/step{s}/caches", caches)
            rows = sv.rows(torch.arange(case["batch"]))
            ranks = sv.ranks
            info[name] = {
                "calls": calls,  # each collective this rank made (recorded_calls)
                "args": args,  # the bytes of the prefill's and step 0's arguments
                "coords": {a: int(c) for a, c in ranks.coords.items()},
                "rows": [int(rows[0]), int(rows[-1]) + 1],
                "model": [ranks.model.rank, ranks.model.world],
                "batch": [ranks.batch.rank, ranks.batch.world],
                "param_blocks": sum(int(v.numel()) for v in tree_flatten(params)[0]),
                "cache_specs": dict(zip(_paths(sv.abstract_caches),
                                        [spec_json(s) for s in
                                         tree_flatten(sv.abstract_caches)[1].flatten_up_to(
                                             sv.cache_specs)])),
            }
    finally:
        group.close()
    np.savez(f"{out}.rank{rank}.npz", **res)
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(info))


# ------------------------------------------------------- running both sides


def run_both(tmp: Path, timeout: float = 240.0, during=None) -> tuple:
    """Write the inputs, run the reference (one process) and the port's 8
    ranks at once, and ``during(inputs)`` (if given) in this process
    meanwhile, all within ``timeout`` seconds.  Returns ``(inputs, ref
    arrays, ref info, [per-rank arrays], [per-rank info], during's
    result)``."""
    inp = tmp / "inputs.npz"
    make_inputs(inp)
    _, x = _load(inp)
    me = str(Path(__file__).resolve())
    procs = [spawn([sys.executable, me, "reference", str(inp), str(tmp / "ref")],
                   tmp / "ref.log", _env())]
    procs += [spawn([sys.executable, me, "port", str(r), str(tmp / "port.store"), str(inp),
                     str(tmp / "port")], tmp / f"port.rank{r}.log", _env(timeout))
              for r in range(WORLD)]
    try:
        got = during(x) if during is not None else None
    finally:
        finish(procs, timeout)
    ref = dict(np.load(tmp / "ref.npz")), json.loads((tmp / "ref.json").read_text())
    ports = [dict(np.load(tmp / f"port.rank{r}.npz")) for r in range(WORLD)]
    infos = [json.loads((tmp / f"port.rank{r}.json").read_text()) for r in range(WORLD)]
    return x, ref[0], ref[1], ports, infos, got


def block(whole: np.ndarray, spec: list, coords: dict) -> np.ndarray:
    """The block of ``whole`` that the device at ``coords`` holds under
    ``spec`` (JSON entries) on ``LAYOUT``."""
    from repro_torch.launch.shards import block_slices, spec_block

    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    grid, b = spec_block(whole.shape, spec, LAYOUT, coords)
    return whole[block_slices(whole.shape, grid, b)]


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference_main(*sys.argv[2:4])
    else:
        port_main(int(sys.argv[2]), *sys.argv[3:6])
