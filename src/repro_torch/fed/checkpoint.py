"""Whole-federation checkpointing: kill the server, restart, continue
bit-identically (DESIGN.md §14).

Counterpart of ``repro.fed.checkpoint``, in its ``fedckpt-v1`` layout: one
compressed ``.npz`` holding

  ``fixed/…``       the arrays whose shapes the run spec fixes, under
                    '/'-joined key paths (``repro_torch.checkpoint.io``'s
                    layout): ``server/params``, ``server/estimate``, the
                    downstream compressor state ``down/{residual,rng,step}``
                    and the pool's ``pool/{opt,residual,rng,step}``;
  ``snap/k/i``      leaf i of the scheduler's k-th staleness snapshot;
  ``log/replica/i`` leaf i of the broadcast DeltaLog's replica, and
  ``log/blob/j``    the j-th held broadcast blob (u8), when the server
                    carries a log;
  ``__fedmeta__``   one JSON blob: round counters, rejoin bookkeeping,
                    fired kills, the channel's per-client sync horizon
                    (``last_sync``), the ledger's rows, the log's head,
                    entry rounds and analytic bits (``log``), and the
                    pending round of a mid-round kill.

:func:`restore_fed_state` writes it back into a freshly built scheduler of
the same spec (shapes are checked against its state), after which
``resume_pending()`` + ``run(..., start_round=...)`` continues the run bit
for bit.  The log's held entries re-decode from their bytes through the
server's ``down_wire``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import _flatten_with_paths, _numpy, _rebuild
from repro_torch.core.ledger import BandwidthLedger, RoundRecord
from repro_torch.core.policy import CompressorState
from repro_torch.core.tree import tree_flatten

PyTree = Any

FORMAT = "fedckpt-v1"


def _fixed_tree(sched) -> Dict[str, Any]:
    """The template-shaped half: every array whose shape the run spec
    fixes (restore checks them against a freshly built scheduler)."""
    server = sched.server
    down = server._down_state
    return {
        "server": {"params": server.params, "estimate": server.estimate},
        "down": {"residual": down.residual, "rng": down.rng, "step": down.step},
        "pool": sched.pool.export_state(),
    }


def save_fed_state(path: str, sched, rounds_done: Optional[int] = None) -> None:
    """Checkpoint a :class:`~repro_torch.fed.scheduler.RoundScheduler`
    (server + pool + channel) to ``path``.  ``rounds_done`` records how many
    rounds completed (a mid-round kill counts its round as NOT done —
    ``resume_pending`` finishes it after restore).  Reading the tensors
    waits for the device."""
    arrays: Dict[str, np.ndarray] = {}
    bf16 = []

    def put(key: str, value) -> None:
        arrays[key] = _numpy(value)
        if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
            bf16.append(key)

    for k, v in _flatten_with_paths(_fixed_tree(sched)).items():
        put(f"fixed/{k}", v)
    for k, snap in enumerate(sched._snapshots):
        for i, leaf in enumerate(tree_flatten(snap)[0]):
            put(f"snap/{k}/{i}", leaf)

    log = getattr(sched.server, "delta_log", None)
    log_meta = None
    if log is not None:
        st = log.state_dict()
        for i, rep in enumerate(st["replica"]):
            arrays[f"log/replica/{i}"] = rep
        for j, (_, blob, _) in enumerate(st["entries"]):
            arrays[f"log/blob/{j}"] = np.frombuffer(blob, np.uint8)
        log_meta = {
            "head": st["head"],
            "entry_rounds": [r for r, _, _ in st["entries"]],
            "entry_bits": [b for _, _, b in st["entries"]],
        }

    ch = sched.channel
    meta = {
        "format": FORMAT,
        "bf16": bf16,
        "rounds_done": rounds_done,
        "n_snapshots": len(sched._snapshots),
        "last_download": {str(k): int(v) for k, v in sched._last_download.items()},
        "failed": {str(k): int(v) for k, v in sched._failed.items()},
        "kills_fired": sorted([int(r), s] for r, s in sched._kills_fired),
        "last_sync": {str(k): int(v) for k, v in ch._last_sync.items()},
        "pending": ch._pending,
        "ledger": [dataclasses.asdict(rec) for rec in ch.ledger.records],
        "log": log_meta,
    }
    arrays["__fedmeta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def restore_fed_state(path: str, sched) -> dict:
    """Restore :func:`save_fed_state` output into ``sched`` — a freshly
    built scheduler of the SAME run spec (shapes are checked against its
    template state).  Returns the checkpoint meta (``rounds_done``, the
    ``pending`` mid-round payload, ...)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__fedmeta__"]).decode())
        data = {k: z[k] for k in z.files if k != "__fedmeta__"}
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint "
                         f"(format={meta.get('format')!r})")

    # -- template-shaped half: restore into the fresh scheduler's structure
    tmpl = _fixed_tree(sched)
    fixed = {k[len("fixed/"):]: v for k, v in data.items() if k.startswith("fixed/")}
    want = _flatten_with_paths(tmpl)
    missing = sorted(set(want) - set(fixed))
    if missing:
        raise ValueError(f"checkpoint {path} is missing arrays {missing[:5]}")
    for k, leaf in want.items():
        if tuple(np.shape(fixed[k])) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch at fixed/{k}: checkpoint "
                             f"{np.shape(fixed[k])} vs template {np.shape(leaf)}")
    server = sched.server
    server.params = _rebuild(server.params, fixed, "server/params")
    server.estimate = _rebuild(server.estimate, fixed, "server/estimate")
    down = server._down_state
    server._down_state = CompressorState(
        residual=_rebuild(down.residual, fixed, "down/residual"),
        rng=_rebuild(down.rng, fixed, "down/rng"),
        step=_rebuild(down.step, fixed, "down/step"))
    sched.pool.import_state(_rebuild(tmpl["pool"], fixed, "pool"))

    # -- staleness snapshot ring (saved newest-first, deque iteration order)
    sched._snapshots.clear()
    for k in range(int(meta["n_snapshots"])):
        leaves = [torch.from_numpy(np.array(data[f"snap/{k}/{i}"])).to(e.device)
                  for i, e in enumerate(tree_flatten(server.estimate)[0])]
        sched._snapshots.append(tree_flatten(server.estimate)[1].unflatten(leaves))

    # -- DeltaLog: replica set directly, window entries re-decoded from
    #    their stored bytes through the same down-wire contract
    log = getattr(server, "delta_log", None)
    if (log is None) != (meta["log"] is None):
        raise ValueError(
            "checkpoint and scheduler disagree on delta_horizon "
            f"(checkpoint log: {meta['log'] is not None}, "
            f"scheduler log: {log is not None})")
    if log is not None:
        lm = meta["log"]

        def get(key: str) -> np.ndarray:
            if key not in data:
                raise ValueError(f"checkpoint {path} is missing array {key!r}")
            return data[key]

        log.restore({
            "head": lm["head"],
            "replica": [get(f"log/replica/{i}") for i in range(len(log._replica))],
            "entries": [(r, get(f"log/blob/{j}").tobytes(), b)
                        for j, (r, b) in enumerate(zip(lm["entry_rounds"], lm["entry_bits"]))],
        }, wire_for_round=server.down_wire)

    # -- bookkeeping: rejoin maps, fired kills, sync horizon, ledger, pending
    sched._last_download = {int(k): int(v) for k, v in meta["last_download"].items()}
    sched._failed = {int(k): int(v) for k, v in meta["failed"].items()}
    sched._kills_fired = {(int(r), str(s)) for r, s in meta["kills_fired"]}
    ch = sched.channel
    ch._last_sync = {int(k): int(v) for k, v in meta["last_sync"].items()}
    ch._pending = meta["pending"]
    ch.ledger = BandwidthLedger()
    for rec in meta["ledger"]:
        rec = dict(rec)
        rec["cohort"] = tuple(int(c) for c in rec["cohort"])
        ch.ledger.record(RoundRecord(**rec))
    return meta
