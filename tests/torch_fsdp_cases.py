"""Train-step cases of the GSPMD backend with one rank a device, run both
ways by the port: on gloo ranks of one device each, and as one rank
holding its client's devices (the path whose numbers are kept as they
were, the oracle here).

    python tests/torch_fsdp_cases.py RANK WORLD STORE OUT NAME...

Each case is a reduced config on a layout, two rounds (one for the
mixtral aux case) from the same drawn state (a CPU generator seeded 0)
on the same markov batches (``make_lm_task``, seed 0, the pod's batch a
round): the ranks take their "data" share of its rows.  :func:`run_case`
returns what the tests compare: the losses, the whole params after each
round (``params_to_tree``), client 0's transmitted ΔW* of each round
(rank 0), the Eq. 1 bits, the state's shapes, each MoE layer's aux term,
and whether gathering the params and cutting them again gives every
rank's blocks back exactly.  The name ``PEAK``, first in a rank's list,
measures the host memory of a larger ``init_state`` (:func:`init_peak`).
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from torch_dist_cases import WIDE, _env, gloo_timeout, recorded_calls, spawn  # noqa: E402

LAYOUT = {"data": 2, "model": 2}
BATCH, SEQ = 4, 8
CASES = {
    "dense": dict(compressor="dense", fast=False),
    "exact-pack": dict(fast=True, flat_engine="exact", device_pack=True, measure=True),
    "hist": dict(fast=True, flat_engine="hist", measure=True),
    "leaf-momentum": dict(fast=False, measure=True, local_opt="momentum"),
    "mixtral-aux": dict(preset="mixtral_8x7b", layout={"data": 2, "model": 1},
                        compressor="dense", fast=False, rounds=1),
    # flat dispatch (llama4's "flat_ep") at a capacity factor that drops
    # pairs: capacity and slots over the pod's batch, not a rank's share
    "llama4-flat": dict(preset="llama4_maverick_400b_a17b", layout={"data": 2, "model": 1},
                        compressor="dense", fast=False, rounds=2,
                        changes=dict(moe_capacity_factor=0.5)),
}
MOE = ("mixtral-aux", "llama4-flat")


def case_cfg(case: dict):
    """The port's config of a case: the reduced preset (granite-20b widened
    by ``WIDE``), FSDP, f32 leaves and residual."""
    import torch

    from repro_torch.configs.base import get_config, reduced

    preset = case.get("preset", "granite_20b")
    extra = dict(WIDE) if preset == "granite_20b" else {}
    cfg = reduced(get_config(preset), **extra, **case.get("changes", {}), fsdp=True,
                  dtype=torch.float32, residual_dtype=torch.float32)
    return dataclasses.replace(cfg, local_opt=case.get("local_opt", cfg.local_opt))


def run_case(name: str, group=None) -> tuple:
    """Case ``name`` on ``group`` (None: one rank holding the client's
    devices, on the CPU); returns ``(arrays, info)``."""
    import torch

    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import make_lm_task
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.shards import block_of
    from repro_torch.models import moe as moe_lib

    case = CASES[name]
    cfg = case_cfg(case)
    task = make_lm_task(vocab=cfg.vocab_size, batch=BATCH, seq_len=SEQ, seed=0, device="cpu")
    fns = build_dist_train(cfg, group=group, device=None if group else "cpu",
                           compressor=case.get("compressor", "sbc"), sparsity=0.01,
                           fast=case["fast"], flat_engine=case.get("flat_engine", "exact"),
                           measure=case.get("measure", False),
                           device_pack=case.get("device_pack", False),
                           mesh_shape=case.get("layout", LAYOUT))
    state = fns.init_state(torch.Generator().manual_seed(0))
    arrays, info = {}, {"bits": fns.bits_per_client, "losses": [], "aux": []}
    info["shapes"] = {key: [list(v.shape) for v in tree_flatten(state[key])[0]]
                      for key in ("params", "opt", "residual")}
    apply = moe_lib.moe_apply

    def observed(*args, **kw):
        out = apply(*args, **kw)
        info["aux"].append(float(out[1].detach()))
        return out

    moe_lib.moe_apply = observed
    try:
        for r in range(case.get("rounds", 2)):
            batch = {k: v[None] for k, v in task.sample(r, 0).items()}
            if r == 0 and group is not None:  # what the dry run holds against this rank
                info["batch"] = {k: [list(v.shape), str(v.dtype)] for k, v in batch.items()}
                # the state's storages and the batch's tensors (its rows are
                # views of one storage here; a dry run's are tensors of their own)
                info["args0"] = tree_bytes(state) + sum(v.numel() * v.element_size()
                                                        for v in batch.values())
                with recorded_calls([]) as calls:
                    state, m = fns.train_step(state, batch)
                info["calls0"] = calls
            else:
                state, m = fns.train_step(state, batch)
            info["losses"].append(float(m["loss"]))
            whole = fns.params_to_tree(state["params"])
            for i, v in enumerate(tree_flatten(whole)[0]):
                arrays[f"{r}/params/{i}"] = v.detach().numpy()
            if "own_client0" in m:
                for i, v in enumerate(tree_flatten(m["own_client0"])[0]):
                    arrays[f"{r}/own/{i}"] = v.numpy()
    finally:
        moe_lib.moe_apply = apply
    # the gathered params cut again: this rank's blocks, exactly
    if fns.ranks is not None:
        info["split_exact"] = all(
            torch.equal(block_of(w, lb.grid, lb.dev_block[fns.ranks.device]), v)
            for v, w, lb in zip(tree_flatten(state["params"])[0], tree_flatten(whole)[0],
                                fns.blocks))
        info["n_shards"] = [math.prod(lb.grid) for lb in fns.blocks]
        info["device"] = fns.ranks.device
        info["residual_whole"] = [list(v.shape) for v in tree_flatten(
            fns.residual_to_tree(state["residual"]))[0]]
    return arrays, info


# the host-memory probe of init_state: granite widened so that its f32
# params (about 0.5 GB whole) stand well above a process's noise
PEAK = "init-peak"
PEAK_WIDE = dict(WIDE, d_model=1024, d_ff=4096, vocab_size=8192, n_layers=8)


def _status_bytes(field: str) -> int:
    """A ``kB`` field of this process's ``/proc/self/status`` in bytes."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith(field + ":"):
            return int(line.split()[1]) * 1024
    raise RuntimeError(f"/proc/self/status has no {field}")


def init_peak(group) -> dict:
    """The host memory this rank's ``init_state`` takes (its high-water
    mark less its resident size before), beside the whole model's bytes,
    the returned state's and the most one draw holds whole (a superblock
    of the scanned stack, or the largest other leaf): granite widened by
    ``PEAK_WIDE`` on ``LAYOUT``, the flat hist path.  Run first in a fresh
    process, so that the mark is the init's."""
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.policy import path_str
    from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.models.model import build_model

    cfg = reduced(get_config("granite_20b"), **PEAK_WIDE, fsdp=True, dtype=torch.float32,
                  residual_dtype=torch.float32)
    fns = build_dist_train(cfg, group=group, sparsity=0.01, fast=True, flat_engine="hist",
                           mesh_shape=LAYOUT)
    with torch.device("meta"):
        meta = tree_flatten_with_path(build_model(cfg).init(torch.Generator()))[0]
    nbytes = {path_str(p): v.numel() * v.element_size() for p, v in meta}
    scan = sum(b for k, b in nbytes.items() if k.startswith("stack/scan/"))
    before = _status_bytes("VmRSS")
    state = fns.init_state(torch.Generator().manual_seed(0))
    peak = _status_bytes("VmHWM") - before
    held = sum(v.numel() * v.element_size() for key in ("params", "opt", "residual")
               for v in tree_flatten(state[key])[0])
    return dict(peak=peak, whole=sum(nbytes.values()), state=held,
                drawn=max([scan // cfg.n_layers] + [b for k, b in nbytes.items()
                                                     if not k.startswith("stack/scan/")]))


def start_ranks(tmp: Path, world: int, names: list, tag: str, wait_s: float = None) -> list:
    """``world`` gloo ranks of the cases ``names``, one process each, each
    waiting ``wait_s`` seconds at most for the others (default the port's
    ``TIMEOUT``)."""
    return [spawn([sys.executable, str(Path(__file__).resolve()), str(r), str(world),
                   str(tmp / f"{tag}.store"), str(tmp / tag)] + list(names),
                  tmp / f"{tag}.rank{r}.log",
                  dict(_env(wait_s), MALLOC_MMAP_THRESHOLD_=str(1 << 20))) for r in range(world)]


def load(tmp: Path, tag: str, world: int) -> list:
    """Each rank's ``{case: (arrays, info)}``."""
    out = []
    for r in range(world):
        info = json.loads((tmp / f"{tag}.rank{r}.json").read_text())
        with np.load(tmp / f"{tag}.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        out.append({name: ({k.split("|", 1)[1]: v for k, v in arrays.items()
                            if k.split("|", 1)[0] == name}, info[name]) for name in info})
    return out


def main(rank: int, world: int, store: str, out: str, names: list) -> None:
    import torch

    from repro_torch.launch.mesh import ClientGroup

    torch.set_num_threads(1)
    group = ClientGroup.connect(rank=rank, world=world, device="cpu", backend="gloo",
                                init_method=f"file://{store}", timeout=gloo_timeout())
    arrays, info = {}, {}
    try:
        for name in names:
            if name == PEAK:
                info[name] = init_peak(group)
                continue
            a, info[name] = run_case(name, group)
            arrays.update({f"{name}|{k}": v for k, v in a.items()})
    finally:
        group.close()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(info))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5:])
