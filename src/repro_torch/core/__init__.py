"""Compression core of the port: the staged codec pipeline (stages →
codec → policy → api, with ``sbc`` and the paper's baselines
registered), the sparsity schedules, the SBW1 wire and the analytic
bits, the flat layout and its engines, the channel and the ledger."""
from repro_torch.core import baselines as _baselines  # noqa: F401  (registers the baselines)
from repro_torch.core import sbc as _sbc  # noqa: F401  (registers "sbc")
