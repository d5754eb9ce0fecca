from maskflownet_torch.training.engine import TrainSettings, Trainer
from maskflownet_torch.training.schedule import lr_at_step, total_steps

__all__ = ["TrainSettings", "Trainer", "lr_at_step", "total_steps"]
