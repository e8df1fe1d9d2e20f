"""Delta broadcast (DESIGN.md §13): counterpart of ``repro.serve``.

  :mod:`repro_torch.serve.deltalog`   DeltaLog — the server's broadcasts
                                      logged once, SBD1 stacked and full
                                      catch-up messages
  :mod:`repro_torch.serve.broadcast`  CatchupPlanner, SubscriberPool and
                                      simulate_fanout — fan-out to 10k–100k
                                      subscribers on the card

The reference's ``ServeEngine`` (prefill and decode of a transformer)
needs the decoder zoo, which comes with ROADMAP A12, part 2; the name
raises until then.
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

__all__ = [
    "CatchupMessage",
    "CatchupPlan",
    "CatchupPlanner",
    "DeltaLog",
    "SubscriberPool",
    "apply_catchup",
    "apply_catchup_flat",
    "apply_plan",
    "simulate_fanout",
]


def __getattr__(name: str):
    if name == "ServeEngine":
        raise NotImplementedError(
            "not ported yet: ServeEngine (serve/engine.py) needs the transformer "
            "of the decoder zoo, which comes with ROADMAP A12, part 2"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
