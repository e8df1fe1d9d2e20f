"""Client-side optimizers of the port."""
from repro_torch.optim.optimizers import AdamState, Optimizer, get_optimizer

__all__ = ["AdamState", "Optimizer", "get_optimizer"]
