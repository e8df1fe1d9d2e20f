"""Compression core of the port: the staged codec pipeline (stages →
codec → policy → api, with ``sbc`` and the paper's baselines
registered), the sparsity schedules, the SBW1 wire and the analytic
bits, the flat layout and its engines, the channel and the ledger.

Counterpart of ``repro.core``: the same 35 public names, so code written
against ``from repro.core import …`` moves to the port by its package
name."""
from repro_torch.core import baselines as _baselines  # noqa: F401  (registers the baselines)
from repro_torch.core import sbc as _sbc  # noqa: F401  (registers "sbc")
from repro_torch.core.api import (
    CompressionPolicy,
    Compressor,
    CompressorState,
    LeafCompressed,
    PolicyRule,
    available,
    get_compressor,
    make_compressor,
)
from repro_torch.core.baselines import dgc_policy
from repro_torch.core.channel import (
    ChannelBits,
    CommChannel,
    FedWireChannel,
    LocalVmapChannel,
    ShardedGspmdChannel,
    resolve_cached,
)
from repro_torch.core.codec import Codec, available_codecs, make_codec
from repro_torch.core.golomb import (
    decode_positions,
    encode_positions,
    expected_position_bits,
    golomb_bstar,
)
from repro_torch.core.ledger import BandwidthLedger, RoundRecord
from repro_torch.core.policy import ResolvedPolicy
from repro_torch.core.sbc import SBC_PRESETS
from repro_torch.core.sparsity import SparsitySchedule, adaptive_total_budget, constant, preset
from repro_torch.core.stages import available_stages, decompress_leaf
from repro_torch.core.wire import LeafSpec, Wire, wire_for

__all__ = [
    "BandwidthLedger",
    "ChannelBits",
    "Codec",
    "CommChannel",
    "CompressionPolicy",
    "FedWireChannel",
    "LocalVmapChannel",
    "RoundRecord",
    "ShardedGspmdChannel",
    "Compressor",
    "CompressorState",
    "LeafCompressed",
    "LeafSpec",
    "PolicyRule",
    "ResolvedPolicy",
    "SBC_PRESETS",
    "SparsitySchedule",
    "Wire",
    "adaptive_total_budget",
    "available",
    "available_codecs",
    "available_stages",
    "constant",
    "decode_positions",
    "decompress_leaf",
    "dgc_policy",
    "encode_positions",
    "expected_position_bits",
    "get_compressor",
    "golomb_bstar",
    "make_codec",
    "make_compressor",
    "preset",
    "resolve_cached",
    "wire_for",
]
