"""Synthetic data of the port."""
from repro_torch.data.synthetic import Task, make_classification_task

__all__ = ["Task", "make_classification_task"]
