"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the program's numbers against the
reference (the lower reading), the control's (the reference in TF32,
the precision below the configuration's f32 with TF32 off) and the
planted fault's (the program fed half of each batch's rows, so its mean
is over the rest).  A step that returns its state unchanged reads 1 on
``change3_gap`` by the measure itself and needs no run.

    python3 perfbench/pb_limits.py --workload <cell> --seeds 1,2,3 --out readings.json

One process: the program is built once, and each seed's state is drawn
afresh; the window is not needed, since a training cell's readings come
from its first rounds.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench  # noqa: E402  (sets the paths and cache directories)

import torch  # noqa: E402

import pb_compare  # noqa: E402
import pb_spec  # noqa: E402
import pb_traffic  # noqa: E402


def half_rows(pool: list) -> list:
    return [{k: v[:v.shape[0] // 2] for k, v in batch.items()} for batch in pool]


def readings(spec: dict, seeds: list, device, fault: bool = True) -> list:
    """Per seed ``{seed, program, control, fault}``, each a dict of the
    comparison's numbers."""
    import pb_program

    out = []
    run = None
    for seed in seeds:
        t0 = time.perf_counter()
        pool = pb_traffic.make_pool(spec["traffic"], spec["config"]["model"], seed, device)
        if run is None:
            run = pb_program.build(spec["config"], pool, seed, device)
        row = {"seed": seed}
        feeds = {"program": pool, "fault": half_rows(pool) if fault else None}
        prog = {}
        for name, feed in feeds.items():
            if feed is None:
                continue
            run.task = pb_program.PoolTask(feed)
            state, prog[name] = bench.first_rounds(run, spec, seed, device)
            del state
            gc.collect()
            torch.cuda.empty_cache()
        ref = bench.reference_readings(spec, seed, pool, device)
        for name, got in prog.items():
            row[name] = pb_compare.numbers(got, ref)
        tf32 = bench.reference_readings(spec, seed, pool, device, tf32=True)
        row["control"] = pb_compare.numbers(tf32, ref)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        out.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-fault", action="store_true")
    args = ap.parse_args(argv)
    spec = pb_spec.load(args.workload)
    rows = readings(spec, [int(s) for s in args.seeds.split(",")], torch.device("cuda", 0),
                    fault=not args.no_fault)
    Path(args.out).write_text(json.dumps({"workload": args.workload,
                                          "card": torch.cuda.get_device_name(0),
                                          "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
