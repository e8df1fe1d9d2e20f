"""PyTorch/CUDA port of the ``repro`` package (the JAX package stays the
reference it is held against).

The port mirrors ``repro``'s module layout.  It imports ``torch`` and
numpy only — never ``jax`` and never ``repro`` — and its entry points run
on the CUDA card unless the caller passes ``device="cpu"``.

This slice carries the GSPMD backend's flat hist engine on one card:
``repro_torch.run.build_run(RunSpec(preset="lenet5", backend="gspmd",
fast=True, flat_engine="hist"))``, whose three SBC passes run on the
hand-written CUDA kernels of :mod:`repro_torch.kernels.flat`.
"""
from repro_torch.device import on_cuda, resolve_device

__all__ = ["on_cuda", "resolve_device"]
