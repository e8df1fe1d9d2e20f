"""Delta broadcast (DESIGN.md §13): counterpart of ``repro.serve``.

  :mod:`repro_torch.serve.deltalog`   DeltaLog — the server's broadcasts
                                      logged once, SBD1 stacked and full
                                      catch-up messages
  :mod:`repro_torch.serve.broadcast`  CatchupPlanner, SubscriberPool and
                                      simulate_fanout — fan-out to 10k–100k
                                      subscribers on the card

and the serving engine:

  :mod:`repro_torch.serve.engine`     ServeEngine — prefill, then one
                                      token a step against KV caches
"""
from repro_torch.serve.broadcast import (
    CatchupPlan,
    CatchupPlanner,
    SubscriberPool,
    apply_plan,
    simulate_fanout,
)
from repro_torch.serve.deltalog import (
    CatchupMessage,
    DeltaLog,
    apply_catchup,
    apply_catchup_flat,
)
from repro_torch.serve.engine import ServeEngine

__all__ = [
    "CatchupMessage",
    "CatchupPlan",
    "CatchupPlanner",
    "DeltaLog",
    "ServeEngine",
    "SubscriberPool",
    "apply_catchup",
    "apply_catchup_flat",
    "apply_plan",
    "simulate_fanout",
]

