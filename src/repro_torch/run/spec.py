"""The declarative run specification — ONE frozen value drives any backend.

A full copy of the reference's ``repro.run.spec.RunSpec``: the same fields,
defaults, validation and JSON round trip, so one committed spec file names
the same run in both packages.  It is

  * **frozen + hashable** — usable as a cache key;
  * **JSON round-trippable** (``to_json`` / ``from_json``);
  * **backend-portable** — :func:`repro_torch.run.build_run` builds the
    part of it this port carries and raises ``NotImplementedError`` for
    the rest.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

BACKENDS = ("local", "gspmd", "fed")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything one training run needs, as plain data.

    Profiles are (delay, sparsity, weight) triples — the federated
    heterogeneity axis (``ClientProfile``); empty means one homogeneous
    profile at (``delay``, ``sparsity``, 1.0).
    """

    # ---- what to train
    preset: str = "lenet5"
    backend: str = "local"  # "local" | "gspmd" | "fed"
    rounds: int = 20
    batch: int = 8
    seq_len: int = 64
    lr: Optional[float] = None  # None → the preset config's base_lr
    seed: int = 0

    # ---- compression policy (DESIGN.md §3)
    compressor: str = "sbc"
    sparsity: float = 0.001
    dense_pattern: Optional[str] = None  # path regex → dense32 fallback
    skip_pattern: Optional[str] = None  # path regex → never transmitted
    fast: bool = False  # §10/§11 flat-buffer fast path
    flat_engine: str = "exact"  # "exact" | "hist" (gspmd fast path)
    device_pack: bool = False  # pack Golomb wire words on-device (gspmd)
    measure_wire: bool = False  # meter real bytes into the ledger
    telemetry: bool = False  # repro.obs tracing + metrics (off = no-ops)

    # ---- client topology / schedule
    clients: int = 4
    delay: int = 1  # local steps per round (temporal sparsity)
    cohort: Optional[int] = None  # sampled clients per round (fed; None=all)
    profiles: Tuple[Tuple[int, float, float], ...] = ()  # (delay, p, weight)

    # ---- federated downstream / aggregation (fed backend only)
    down_sparsity: float = 1.0  # 1.0 = dense broadcast
    agg: Optional[str] = None  # None → mean sync / staleness async
    async_rounds: bool = False
    max_staleness: int = 4
    staleness_beta: float = 0.5
    non_iid: bool = False
    skew: float = 2.0
    broadcast_log: bool = False  # downstream rides a serve/ DeltaLog
    delta_horizon: int = 16  # rounds the DeltaLog keeps for catch-ups

    # ---- elasticity / memory (fed backend only, DESIGN.md §14)
    cohort_tile: Optional[int] = None  # members per compiled step (None=all)
    client_store: str = "device"  # "device" | "host" | "memmap" pool state
    straggler_timeout: Optional[float] = None  # abort uploads slower than this
    faults: Optional[str] = None  # FaultSchedule: inline JSON or a file path

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; have {BACKENDS}"
            )
        if self.flat_engine not in ("exact", "hist"):
            raise ValueError(f"unknown flat_engine {self.flat_engine!r}")
        if self.device_pack and (
            self.backend != "gspmd" or not self.fast or self.flat_engine != "exact"
        ):
            raise ValueError(
                "device_pack packs wire words inside the gspmd flat "
                "exchange; it needs backend='gspmd', fast=True and "
                "flat_engine='exact'"
            )
        if self.client_store not in ("device", "host", "memmap"):
            raise ValueError(
                f"unknown client_store {self.client_store!r}; "
                "have ('device', 'host', 'memmap')"
            )
        # normalize JSON-born lists into the hashable tuple form
        object.__setattr__(
            self,
            "profiles",
            tuple(
                (int(d), float(p), float(w))
                for d, p, w in (tuple(t) for t in self.profiles)
            ),
        )

    # ------------------------------------------------------------ (de)spec

    def to_json(self, indent: Optional[int] = 1) -> str:
        """Serialize to JSON (committable; inverse of :meth:`from_json`)."""
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        """Parse a spec committed by :meth:`to_json`; unknown keys raise
        (a typo'd field must not silently fall back to a default)."""
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(f"RunSpec JSON must be an object, got {type(data)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"unknown RunSpec fields {sorted(unknown)}; have {sorted(known)}"
            )
        return cls(**data)

    def replace(self, **kw) -> "RunSpec":
        return dataclasses.replace(self, **kw)
