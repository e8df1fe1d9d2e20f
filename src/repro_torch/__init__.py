"""PyTorch/CUDA port of the ``repro`` package (the JAX package stays the
reference it is held against).

The port mirrors ``repro``'s module layout.  It imports ``torch`` and
numpy only — never ``jax`` and never ``repro`` — and its entry points run
on the CUDA card unless the caller passes ``device="cpu"``.

The port runs the paper's two presets, LeNet5 and CharLSTM
(``preset="lenet5"`` or ``"charlstm"``), on the local backend (the
paper's Alg. 1 round, per leaf or on the flat space) and on the GSPMD
backend on one card with both flat engines:
``repro_torch.run.build_run(RunSpec(preset="lenet5", backend="gspmd",
fast=True, flat_engine="hist"))``, whose three SBC passes run on the
hand-written CUDA kernels of :mod:`repro_torch.kernels.flat`, and
``flat_engine="exact"`` with ``device_pack=True, measure_wire=True``,
whose Golomb wire is packed by the kernels of
:mod:`repro_torch.kernels.pack` and metered into the ledger; either takes
``dense_pattern``/``skip_pattern`` rules (the hist engine all-SBC only).
The GSPMD backend also runs one client per process over
``torch.distributed``, and the fed backend (:mod:`repro_torch.fed`,
``backend="fed"``) a parameter server and a client pool on one card, with
real SBW1 bytes both ways; with ``broadcast_log=True`` its downstream
rides a broadcast log (:mod:`repro_torch.serve`: SBD1 catch-ups, and a
subscriber fan-out on the card).  ``telemetry=True`` traces a run into the
reference's ``repro-obs-v1`` files (:mod:`repro_torch.obs`).

It also carries the codec core as a library, as in the reference:
:mod:`repro_torch.core.stages`, ``codec``, ``policy``, ``api``, ``sbc``,
``residual``, ``bits`` and the SBW1 ``wire`` (byte-compatible with the
reference's), with every scalar a codec sends summed in XLA's f32 order
(:mod:`repro_torch.kernels.reduce`).
"""
from repro_torch.device import on_cuda, resolve_device

__all__ = ["on_cuda", "resolve_device"]
