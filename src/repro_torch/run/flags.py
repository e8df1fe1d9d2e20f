"""The argparse surface of ``python -m repro_torch.run``.

A copy of the reference's ``repro.run.flags``: the same flag names,
defaults and ``--spec-json`` rule, so a command line or a committed spec
file means the same run in both packages.  Flags of the parts this port
does not carry yet parse as they do there; ``build_run`` then raises
``NotImplementedError`` for them.
"""
from __future__ import annotations

import argparse
from typing import Tuple

from repro_torch.run.spec import BACKENDS, RunSpec


def add_compression_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The compression-policy knobs (DESIGN.md §3/§10/§11)."""
    g = ap.add_argument_group("compression policy")
    g.add_argument("--compressor", default="sbc",
                   help="compressor name (the port carries 'sbc')")
    g.add_argument("--sparsity", type=float, default=0.001,
                   help="upstream gradient sparsity rate p")
    g.add_argument("--dense-pattern", default=None,
                   help="path regex: matched leaves ride dense (DGC-style)")
    g.add_argument("--skip-pattern", default=None,
                   help="path regex: matched leaves are never transmitted")
    g.add_argument("--fast", action="store_true",
                   help="flat-buffer compression fast path (DESIGN.md §10/§11)")
    g.add_argument("--flat-engine", choices=["exact", "hist"], default="exact",
                   help="fast-path engine (gspmd backend; DESIGN.md §11)")
    g.add_argument("--device-pack", action="store_true",
                   help="pack Golomb wire words on-device (fused select→pack "
                        "Pallas kernels; gspmd fast path, exact engine)")
    g.add_argument("--measure-wire", action="store_true",
                   help="meter real wire bytes into the channel ledger")
    return ap


def add_telemetry_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The telemetry export knobs (either flag enables telemetry)."""
    g = ap.add_argument_group("telemetry (not ported yet: ROADMAP A11)")
    g.add_argument("--trace", default=None, metavar="PATH",
                   help="write a Perfetto-loadable trace.json of the run")
    g.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the run's metrics as schema-headed JSONL")
    return ap


def telemetry_requested(args: argparse.Namespace) -> bool:
    return bool(getattr(args, "trace", None) or
                getattr(args, "metrics_out", None))


def add_run_flags(ap: argparse.ArgumentParser, **defaults) -> argparse.ArgumentParser:
    """The full shared RunSpec surface; ``defaults`` re-pins per-launcher
    defaults (e.g. the fed launcher's dense-small pattern) without
    re-declaring any flag."""
    ap.add_argument("--preset", default="lenet5",
                    help="model+task preset (repro_torch.run.presets)")
    ap.add_argument("--backend", choices=list(BACKENDS), default="local",
                    help="which CommChannel backend runs the rounds")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: the preset's base_lr)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--delay", type=int, default=1,
                    help="local steps per round (temporal sparsity)")
    add_compression_flags(ap)
    g = ap.add_argument_group("federated topology (fed backend)")
    g.add_argument("--cohort", type=int, default=None,
                   help="sampled clients per round (default: all)")
    g.add_argument("--profiles", default="",
                   help="heterogeneous clients: 'delay:sparsity[:weight],...'")
    g.add_argument("--down-sparsity", type=float, default=1.0,
                   help="broadcast sparsity (1.0 = dense downstream)")
    g.add_argument("--agg", default=None,
                   choices=["mean", "weighted", "staleness"],
                   help="aggregation (default: mean sync / staleness async)")
    g.add_argument("--async", dest="async_mode", action="store_true",
                   help="async rounds with stale client starts")
    g.add_argument("--max-staleness", type=int, default=4)
    g.add_argument("--staleness-beta", type=float, default=0.5)
    g.add_argument("--non-iid", action="store_true",
                   help="per-client Markov chains instead of IID shards")
    g.add_argument("--skew", type=float, default=2.0,
                   help="non-IID interpolation strength")
    g.add_argument("--broadcast-log", action="store_true",
                   help="downstream rides a round-indexed DeltaLog: lagging "
                        "cohort members pull stacked/replay catch-ups")
    g.add_argument("--delta-horizon", type=int, default=16,
                   help="rounds the DeltaLog keeps before forcing full resync")
    e = ap.add_argument_group("federated elasticity (fed backend; DESIGN.md §14)")
    e.add_argument("--cohort-tile", type=int, default=None,
                   help="clients per compiled cohort step (default: the whole "
                        "profile group in one vmap); bounds device memory")
    e.add_argument("--client-store", choices=["device", "host", "memmap"],
                   default="device",
                   help="where per-client pool state lives between rounds "
                        "(memmap scales to 10k+ simulated clients)")
    e.add_argument("--straggler-timeout", type=float, default=None,
                   help="abort uploads whose simulated duration "
                        "delay×slowdown exceeds this (partial aggregation)")
    e.add_argument("--faults", default=None,
                   help="deterministic FaultSchedule: inline JSON or a path "
                        "(drops/slow/corrupt/kill_server)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--history", default=None, help="metrics JSON path")
    ap.add_argument("--spec-json", default=None,
                    help="load a committed RunSpec JSON (other flags ignored)")
    add_telemetry_flags(ap)
    if defaults:
        ap.set_defaults(**defaults)
    return ap


def build_parser(**defaults) -> argparse.ArgumentParser:
    """The parser of ``python -m repro_torch.run``."""
    ap = argparse.ArgumentParser(
        description="One declarative RunSpec (PyTorch port: gspmd hist slice)"
    )
    add_run_flags(ap, **defaults)
    return ap


def parse_profiles(spec_str: str) -> Tuple[Tuple[int, float, float], ...]:
    """'d:p[:w],d:p[:w],...' → ((delay, sparsity, weight), ...); '' → ()."""
    if not spec_str:
        return ()
    out = []
    for part in spec_str.split(","):
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise ValueError(f"bad profile {part!r}; want delay:sparsity[:weight]")
        out.append((
            int(fields[0]), float(fields[1]),
            float(fields[2]) if len(fields) == 3 else 1.0,
        ))
    return tuple(out)


def spec_from_args(args: argparse.Namespace) -> RunSpec:
    """argparse namespace → frozen RunSpec; ``--spec-json`` wins over every
    other flag."""
    if getattr(args, "spec_json", None):
        with open(args.spec_json) as f:
            spec = RunSpec.from_json(f.read())
        if telemetry_requested(args):
            spec = spec.replace(telemetry=True)
        return spec
    return RunSpec(
        preset=args.preset,
        backend=args.backend,
        rounds=args.rounds,
        batch=args.batch,
        seq_len=args.seq_len,
        lr=args.lr,
        seed=args.seed,
        compressor=args.compressor,
        sparsity=args.sparsity,
        dense_pattern=args.dense_pattern,
        skip_pattern=args.skip_pattern,
        fast=args.fast,
        flat_engine=args.flat_engine,
        device_pack=args.device_pack,
        measure_wire=args.measure_wire,
        clients=args.clients,
        delay=args.delay,
        cohort=args.cohort,
        profiles=parse_profiles(args.profiles),
        down_sparsity=args.down_sparsity,
        agg=args.agg,
        async_rounds=args.async_mode,
        max_staleness=args.max_staleness,
        staleness_beta=args.staleness_beta,
        non_iid=args.non_iid,
        skew=args.skew,
        broadcast_log=args.broadcast_log,
        delta_horizon=args.delta_horizon,
        cohort_tile=args.cohort_tile,
        client_store=args.client_store,
        straggler_timeout=args.straggler_timeout,
        faults=args.faults,
        telemetry=telemetry_requested(args),
    )
