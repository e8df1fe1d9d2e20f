"""One declarative run surface (counterpart of ``repro.run``).

  >>> from repro_torch.run import RunSpec, build_run
  >>> run = build_run(RunSpec(preset="lenet5", backend="local", sparsity=0.01,
  ...                         rounds=5, measure_wire=True))
  >>> state, hist = run.run()

CLI: ``python -m repro_torch.run`` with the flags of ``python -m repro.run``.
"""
from repro_torch.run.build import (
    FedRun,
    GspmdRun,
    LocalRun,
    Run,
    build_run,
    lr_schedule,
    policy_from_spec,
)
from repro_torch.run.flags import (
    add_compression_flags,
    add_run_flags,
    build_parser,
    spec_from_args,
)
from repro_torch.run.presets import build_preset
from repro_torch.run.spec import BACKENDS, RunSpec

__all__ = [
    "BACKENDS",
    "FedRun",
    "GspmdRun",
    "LocalRun",
    "Run",
    "RunSpec",
    "add_compression_flags",
    "add_run_flags",
    "build_parser",
    "build_preset",
    "build_run",
    "lr_schedule",
    "policy_from_spec",
    "spec_from_args",
]
