"""RegC gradient synchronisation (``regc_sync/`` of the reference): only
the policy dataclass so far; the sync itself waits for ROADMAP item 13d."""
from repro_torch.regc_sync.policies import RegCSyncPolicy

__all__ = ["RegCSyncPolicy"]
