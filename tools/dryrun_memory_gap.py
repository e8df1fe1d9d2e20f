"""Where does the card hold more memory than the dry run counts?

    python3 tools/dryrun_memory_gap.py   # on a CUDA card

Builds ``chip_smoke.py`` phase 18b's step (granite-20b's 2 full-width
layers, f32, hist engine, one device, batch 4 x 512) on the card and runs
its first step under ``repro_torch.launch.roofline.StepCounter``, the
counter the dry run uses, here on real CUDA tensors.  After every op it
holds the counter's live bytes against ``torch.cuda.memory_allocated``
above the bytes held before the step, and prints each op at which the
card's excess over the count grows by 256 MiB or more (the op, its
output shapes, both numbers), then the step's peaks: the counter's, the
card's (``max_memory_allocated``) and the dry run's on the ``meta``
device for the same step.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.dist import build_dist_train  # noqa: E402
from repro_torch.launch.mesh import make_host_group  # noqa: E402

GIB = 2 ** 30
STEP = 256 * 2 ** 20


class Gap(roofline.StepCounter):
    """The dry run's counter, printing where the card's allocation runs
    ahead of it."""

    def __init__(self, base: int) -> None:
        super().__init__()
        self.base, self.worst, self.n = base, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.n += 1
        gap = torch.cuda.memory_allocated() - self.base - self.live
        if gap >= self.worst + STEP:
            shapes = [tuple(t.shape) for t in roofline._tensors(out)][:3]
            print(f"op {self.n} {func}: outputs {shapes}; card {(gap + self.live) / GIB:.3f} "
                  f"GiB, counted {self.live / GIB:.3f} GiB, excess {gap / GIB:.3f} GiB")
            self.worst = gap
        return out


def main() -> int:
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.card_line()}")
    cfg = chip_smoke.pod_cfg("a")
    layout = chip_smoke.SCALE_LAYOUT
    B, S = chip_smoke.SCALE_B["batch"], chip_smoke.SCALE_B["seq_len"]
    build = dict(sparsity=chip_smoke.SCALE_B["sparsity"], fast=True, flat_engine="hist")
    meta = {k: torch.empty((1, B, S), dtype=torch.int64, device="meta")
            for k in ("tokens", "labels")}
    got = dryrun.dry_train(cfg, layout, meta, **build)
    fns = build_dist_train(cfg, group=make_host_group(dev), mesh_shape=layout, **build)
    state = fns.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, B, S), generator=gen, device=dev)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counter = Gap(base)
    counter.exclude((state, batch))
    with counter:
        fns.train_step(state, batch)
    torch.cuda.synchronize(dev)
    card = torch.cuda.max_memory_allocated(dev) - base
    print(f"arguments {dryrun.tree_bytes((state, batch)) / GIB:.3f} GiB (dry run "
          f"{got['argument_bytes'] / GIB:.3f}); the step's peak above them: counted on the "
          f"card {counter.peak / GIB:.3f} GiB, the card's {card / GIB:.3f} GiB, the dry run's "
          f"{got['temp_bytes'] / GIB:.3f} GiB; {counter.n} ops")
    return 0


if __name__ == "__main__":
    sys.exit(main())
