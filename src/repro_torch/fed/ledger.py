"""The bandwidth ledger under its federated name: a re-export of
:mod:`repro_torch.core.ledger`, as the reference's ``repro.fed.ledger``
re-exports ``repro.core.ledger``."""
from repro_torch.core.ledger import BandwidthLedger, RoundRecord

__all__ = ["BandwidthLedger", "RoundRecord"]
