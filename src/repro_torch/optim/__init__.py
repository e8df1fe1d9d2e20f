"""Client-side optimizers of the port."""
from repro_torch.optim.optimizers import AdamState, Optimizer, adam, get_optimizer, momentum, sgd

__all__ = ["AdamState", "Optimizer", "adam", "get_optimizer", "momentum", "sgd"]
