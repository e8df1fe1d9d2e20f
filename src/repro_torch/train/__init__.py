from repro_torch.train.trainer import DSGDTrainer, TrainState

__all__ = ["DSGDTrainer", "TrainState"]
