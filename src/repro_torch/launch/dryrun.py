"""Dry run on the ``meta`` device: one rank's step of every (arch × input
shape × production layout), with no card and no allocation.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each step for 256 or 512 forced host devices and reads XLA's
``memory_analysis()`` and ``cost_analysis()``.  The port runs one rank
of the layout, one rank a device, on ``meta`` tensors:

  1. the layout is :func:`~repro_torch.launch.mesh.production_layout`,
     (16, 16) ``single`` or (2, 16, 16) ``multi``;
  2. the step is ``build_dist_train`` (``train_4k``), ``make_dist_prefill``
     (``prefill_32k``) or ``make_dist_serve`` (``decode_32k``,
     ``long_500k``), on a :class:`RecordingGroup` of the layout's ranks in
     place of a process group, at rank ``rank`` (0);
  3. it runs once under :class:`~repro_torch.launch.roofline.StepCounter`
     (FLOPs, bytes, the step's live bytes and their peak) and a
     :class:`~repro_torch.launch.roofline.LoopSampler` (a host loop over
     positions or query chunks runs two steps for all of them;
     ``record["loops"]`` lists the trip counts they stood for);
  4. memory takes the place of ``memory_analysis()``: ``argument_bytes``
     (the rank's params, optimizer state, residual and flat buffers,
     caches and batch), ``output_bytes`` (what the step returns) and
     ``temp_bytes`` (the peak of the live bytes of the tensors the step
     makes, its outputs included); the three roofline terms come from
     :func:`repro_torch.launch.roofline.analyze` on the H100's datasheet
     terms, the hand kernels' calls and bytes from their ``meta``
     branches (``repro_torch.kernels._build.META_TALLY``);
  5. a JSON record goes to ``experiments/dryrun_torch/<arch>__<shape>__<
     mesh>.json`` (``--out-dir`` elsewhere).

Usage (the CPU is enough; no card is touched)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch.configs.base import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, input_specs
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.kernels import _build
from repro_torch.launch import roofline
from repro_torch.launch.dist import (build_dist_train, client_topology, make_dist_prefill,
                                     make_dist_serve)
from repro_torch.launch.mesh import ClientGroup, production_layout
from repro_torch.models import hints
from repro_torch.paths import experiments_dir
from repro_torch.run.flags import add_compression_flags

OUT_DIR = experiments_dir("dryrun_torch")
META = torch.device("meta")


class CallLog:
    """The calls a :class:`RecordingGroup` and its sub-groups make, in
    order; ``weight`` is how many times a call counts (a sampled loop's)."""

    def __init__(self) -> None:
        self.calls: list = []
        self.weight = 1


@dataclasses.dataclass(eq=False)
class RecordingGroup(ClientGroup):
    """A stand-in for :class:`~repro_torch.launch.mesh.ClientGroup` in the
    dry run: one rank of a world of ``world`` on ``meta`` tensors, with no
    process group.  Its collectives return ``meta`` tensors of the shapes
    that a real group returns (:meth:`all_gather_rows` and :meth:`pmean`
    are the real group's, over :meth:`gather_list`), and each call of a
    group of more than one rank is recorded in ``log``: its kind, the
    shape and dtype of the tensor given, the bytes it brings in (every
    rank's tensor, or the exchanged rows) and the group's global ranks.
    :meth:`device_ranks` makes the real sub-groups' stand-ins.  Only this
    module makes one."""

    log: Any = None

    @classmethod
    def of(cls, world: int, rank: int = 0, log: Optional[CallLog] = None) -> "RecordingGroup":
        return cls(rank=rank, world=world, device=META,
                   backend="record" if world > 1 else None, log=log or CallLog())

    def _record(self, kind: str, t: torch.Tensor, nbytes: int) -> None:
        self.log.calls.append({"kind": kind, "shape": list(t.shape),
                               "dtype": str(t.dtype).replace("torch.", ""),
                               "bytes": int(nbytes), "world": self.world,
                               "members": list(self.members), "count": self.log.weight})

    def gather_list(self, t: torch.Tensor) -> list:
        if self.backend is None:
            return [t]
        self._record("all-gather", t, self.world * t.numel() * t.element_size())
        return [torch.empty_like(t, device=META) for _ in range(self.world)]

    def exchange_rows(self, rows: torch.Tensor) -> torch.Tensor:
        if self.backend is None:
            return rows
        self._record("all-to-all", rows, rows.numel() * rows.element_size())
        return torch.empty_like(rows, device=META)

    def _sub(self, ranks: list, pg) -> "RecordingGroup":
        return RecordingGroup(rank=ranks.index(self.rank), world=len(ranks), device=META,
                              backend=self.backend if len(ranks) > 1 else None,
                              members=tuple(ranks), log=self.log)

    def _new_group(self, ranks: list):
        return None

    def close(self) -> None:
        return None


def scan_trips_for(cfg) -> int:
    """The trips of a config's superblock loop (``stack_pattern``'s scanned
    superblocks, at least 1)."""
    from repro_torch.models.transformer import stack_pattern

    return max(1, stack_pattern(cfg)[1])


def tree_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (each storage once)."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _run(step, args: tuple, log: CallLog) -> dict:
    """``step(*args)`` once on meta tensors under the counter and the loop
    sampler; the counts, the memory and the kernels' meta calls."""
    counter = roofline.StepCounter()
    counter.exclude(args)
    sampler = roofline.LoopSampler(counter, tallies=(log,))
    _build.reset_meta()
    t0 = time.perf_counter()
    with counter, hints.sampled_loops(sampler):
        out = step(*args)
    return {"counter": counter, "loops": sampler.loops,
            "run_s": time.perf_counter() - t0,
            "kernels": {k: {"launches": n, "bytes": b}
                        for k, (n, b) in sorted(_build.META_TALLY.items())},
            "argument_bytes": tree_bytes(args), "output_bytes": tree_bytes(out),
            "temp_bytes": counter.peak}


def dry_train(cfg, layout: dict, batch: dict, *, rank: int = 0, log: Optional[CallLog] = None,
              **build) -> dict:
    """Rank ``rank``'s train step, one rank a device of ``layout``, on
    ``batch`` (every client's rows, ``(C, per, ...)``, any device: only
    shapes are read).  ``build``: ``build_dist_train``'s options."""
    log = log or CallLog()
    group = RecordingGroup.of(math.prod(layout.values()), rank, log)
    fns = build_dist_train(cfg, group=group, mesh_shape=layout, **build)
    log.calls.clear()  # the build's own calls are none; keep the step's alone
    with torch.device(META):
        state = fns.init_state(torch.Generator())
    mine = tree_map(lambda v: torch.empty_like(v[fns.client:fns.client + 1], device=META), batch)
    got = _run(fns.train_step, (state, mine), log)
    got.update(unit="train_step", fns=fns, log=log, n_clients=fns.channel.n_clients,
               bits_per_client=fns.bits_per_client, bits_dense=fns.bits_dense,
               flat_fast=fns.flat_space is not None)
    return got


def dry_prefill(cfg, layout: dict, batch: dict, *, rank: int = 0,
                log: Optional[CallLog] = None) -> dict:
    """Rank ``rank``'s prefill of the whole ``batch``, one rank a device."""
    log = log or CallLog()
    group = RecordingGroup.of(math.prod(layout.values()), rank, log)
    fns = make_dist_prefill(cfg, group=group, mesh_shape=layout)
    with torch.device(META):
        params = fns.init_params(torch.Generator())
    got = _run(fns.prefill, (params, tree_map(lambda t: t.to(META), batch)), log)
    got.update(unit="prefill", fns=fns, log=log)
    return got


def dry_decode(cfg, layout: dict, *, batch: int, seq_len: int, pos: int, rank: int = 0,
               log: Optional[CallLog] = None, tokens_dtype=torch.int32) -> dict:
    """Rank ``rank``'s one-token decode step against ``seq_len``-deep caches
    of ``batch`` rows at position ``pos``, one rank a device, the tokens in
    ``tokens_dtype`` (the reference's int32)."""
    log = log or CallLog()
    group = RecordingGroup.of(math.prod(layout.values()), rank, log)
    fns = make_dist_serve(cfg, group=group, batch=batch, seq_len=seq_len, mesh_shape=layout)
    with torch.device(META):
        params = fns.init_params(torch.Generator())
        caches = fns.caches_from_tree(fns.abstract_caches)
    tokens = torch.empty((batch, 1), dtype=tokens_dtype, device=META)

    def step(params, tokens, caches):
        return fns.serve_step(params, tokens, caches, pos)

    got = _run(step, (params, tokens, caches), log)
    got.update(unit="serve_step", fns=fns, log=log)
    return got


def lower_pair(cfg, shape_name: str, layout: dict, *, compressor: str = "sbc",
               sparsity: float = 0.001, opts: frozenset = frozenset(), fast: bool = False,
               flat_engine: str = "exact", rank: int = 0) -> dict:
    """Rank ``rank``'s step of ``(cfg, shape_name)`` on ``layout``, run
    once on meta tensors (:func:`dry_train`, :func:`dry_prefill` or
    :func:`dry_decode`)."""
    shape = INPUT_SHAPES[shape_name]
    kind = shape["kind"]
    if kind == "train":
        n_clients, _ = client_topology(cfg, layout)
        return dry_train(cfg, layout, input_specs(cfg, shape_name, n_clients=n_clients),
                         rank=rank, compressor=compressor, sparsity=sparsity, opts=opts,
                         fast=True if fast else None, flat_engine=flat_engine)
    if kind == "prefill":
        return dry_prefill(cfg, layout, input_specs(cfg, shape_name), rank=rank)
    return dry_decode(cfg, layout, batch=shape["global_batch"], seq_len=shape["seq_len"],
                      pos=shape["seq_len"] - 1, rank=rank)


def pod_groups(layout: dict, calls: list) -> list:
    """The recorded groups whose ranks span more than one "pod"
    coordinate (priced across nodes)."""
    if layout.get("pod", 1) == 1:
        return []
    per_pod = math.prod(v for a, v in layout.items() if a != "pod")
    return [c["members"] for c in calls
            if len({r // per_pod for r in c["members"]}) > 1]


def summarize(got: dict, cfg, shape_name: str, layout: dict) -> dict:
    """The record's memory, roofline, kernel and collective fields."""
    shape = INPUT_SHAPES[shape_name]
    calls = got["log"].calls
    coll = roofline.collective_stats(calls, pod_groups=pod_groups(layout, calls),
                                     scale=[c["count"] for c in calls])
    kernel_bytes = sum(k["bytes"] for k in got["kernels"].values())
    rf = roofline.analyze(got["counter"], coll, n_devices=math.prod(layout.values()),
                          model_flops=roofline.model_flops_for(cfg, shape, shape["kind"]),
                          kernel_bytes=kernel_bytes)
    kinds: dict = {}
    for c in calls:
        kinds[c["kind"]] = kinds.get(c["kind"], 0) + c["count"]
    return {
        "run_s": round(got["run_s"], 1),
        "memory": {"argument_bytes": got["argument_bytes"], "output_bytes": got["output_bytes"],
                   "temp_bytes": got["temp_bytes"], "generated_code_bytes": None},
        "roofline": rf.summary(),
        "ops": got["counter"].ops,
        "kernels": got["kernels"],
        "collectives": kinds,
        "loops": got["loops"],
    }


def run_pair(arch: str, shape_name: str, multi_pod: bool, *, compressor="sbc",
             sparsity=0.001, save=True, verbose=True, opts: frozenset = frozenset(),
             fast: bool = False, flat_engine: str = "exact", out_dir: str = None) -> dict:
    cfg = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    if opts:
        mesh_name += "+" + "+".join(sorted(opts))
    record: dict = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
                    "compressor": compressor, "opts": sorted(opts)}
    reason = cfg.skip_reason(shape_name)
    if reason:
        record["status"] = "skip"
        record["reason"] = reason
        if verbose:
            print(f"[skip]   {cfg.name} × {shape_name}: {reason}")
        return record

    layout = production_layout(multi_pod=multi_pod)
    try:
        got = lower_pair(cfg, shape_name, layout, compressor=compressor, sparsity=sparsity,
                         opts=opts, fast=fast, flat_engine=flat_engine)
        record.update({k: got[k] for k in ("unit", "n_clients", "bits_per_client",
                                           "bits_dense", "flat_fast") if k in got})
        record.update(summarize(got, cfg, shape_name, layout))
        record["status"] = "ok"
        if verbose:
            rf, mem = record["roofline"], record["memory"]
            print(f"[ok]     {cfg.name} × {shape_name} × {mesh_name}  run {record['run_s']}s  "
                  f"args/dev {mem['argument_bytes'] / 2**30:.2f} GiB  temp/dev "
                  f"{mem['temp_bytes'] / 2**30:.2f} GiB  dominant={rf['dominant']}  "
                  f"(C={rf['compute_s']:.3f}s M={rf['memory_s']:.3f}s "
                  f"X={rf['collective_s']:.3f}s)")
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[ERROR]  {cfg.name} × {shape_name} × {mesh_name}: {record['error'][:200]}")
    if save:
        out_dir = out_dir or OUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        key = cfg.name.replace("/", "_")
        path = os.path.join(out_dir, f"{key}__{shape_name}__{mesh_name}.json")
        slim = {k: v for k, v in record.items() if k != "traceback"}
        with open(path, "w") as f:
            json.dump(slim, f, indent=1, default=str)
    return record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dry run of one rank's step on the meta device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--opts", default="", help="comma list: lean_moe,seq_every2")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help="record directory (default experiments/dryrun_torch)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs run at once, one process each (default 1: in this process)")
    # the shared compression surface (compressor, sparsity, fast and the
    # flat engine bear on the step)
    add_compression_flags(ap)
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    opts = frozenset(o for o in args.opts.split(",") if o)
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    pairs = [(arch, shape, mp) for arch in archs for shape in shapes for mp in meshes]
    kw = dict(compressor=args.compressor, sparsity=args.sparsity, opts=opts, fast=args.fast,
              flat_engine=args.flat_engine, out_dir=args.out_dir)
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = [ex.submit(run_pair, *pair, **kw) for pair in pairs]
            results = [f.result() for f in futures]
    else:
        results = [run_pair(*pair, **kw) for pair in pairs]
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run: {ok} ok / {skip} skip / {err} error ==")
    if err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
