"""One declarative run surface (counterpart of ``repro.run``).

  >>> from repro_torch.run import RunSpec, build_run
  >>> run = build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
  ...                         flat_engine="hist", sparsity=0.01, rounds=5))
  >>> state, hist = run.run()

CLI: ``python -m repro_torch.run`` with the flags of ``python -m repro.run``.
"""
from repro_torch.run.build import GspmdRun, build_run
from repro_torch.run.flags import build_parser, spec_from_args
from repro_torch.run.presets import build_preset
from repro_torch.run.spec import BACKENDS, RunSpec

__all__ = [
    "BACKENDS",
    "GspmdRun",
    "RunSpec",
    "build_parser",
    "build_preset",
    "build_run",
    "spec_from_args",
]
