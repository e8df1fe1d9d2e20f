"""Federated orchestration (DESIGN.md §9): counterpart of ``repro.fed``.

The paper's §I parameter-server deployment on top of the codec and wire
stack, with the reference's modules and public names:

  :mod:`repro_torch.fed.server`     ParameterServer — decode SBW1 uploads,
                                    aggregate (mean, weighted, staleness),
                                    compress the downstream broadcast
  :mod:`repro_torch.fed.clients`    ClientPool — partial participation over
                                    heterogeneous client profiles, cohorts
                                    compressed as rows a tile
  :mod:`repro_torch.fed.scheduler`  RoundScheduler — sync and async rounds,
                                    dropout/rejoin + straggler timeouts
  :mod:`repro_torch.fed.faults`     FaultSchedule — deterministic, seeded
                                    fault injection
  :mod:`repro_torch.fed.checkpoint` save/restore the WHOLE federation state,
                                    bit-identical resume (mid-round too)
  :mod:`repro_torch.fed.ledger`     BandwidthLedger — bidirectional measured
                                    vs analytic byte accounting

Entry points: ``python -m repro_torch.run --backend fed`` and
``python -m repro_torch.launch.fed``.
"""
from repro_torch.fed.checkpoint import restore_fed_state, save_fed_state
from repro_torch.fed.clients import (
    CLIENT_STORES,
    ClientPool,
    ClientProfile,
    CohortResult,
    SpilledClientStore,
)
from repro_torch.fed.faults import KILL_STEPS, NO_FAULTS, FaultSchedule, ServerKilled
from repro_torch.fed.ledger import BandwidthLedger, RoundRecord
from repro_torch.fed.scheduler import RoundScheduler
from repro_torch.fed.server import (
    AGGREGATORS,
    Broadcast,
    ClientUpdate,
    ParameterServer,
    staleness_weights,
)

__all__ = [
    "AGGREGATORS",
    "BandwidthLedger",
    "Broadcast",
    "CLIENT_STORES",
    "ClientPool",
    "ClientProfile",
    "ClientUpdate",
    "CohortResult",
    "FaultSchedule",
    "KILL_STEPS",
    "NO_FAULTS",
    "ParameterServer",
    "RoundRecord",
    "RoundScheduler",
    "ServerKilled",
    "SpilledClientStore",
    "restore_fed_state",
    "save_fed_state",
]
