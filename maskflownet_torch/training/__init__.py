from maskflownet_torch.training.engine import (TrainSettings, Trainer,
                                               nchw_batch)
from maskflownet_torch.training.schedule import lr_at_step, total_steps

__all__ = ["TrainSettings", "Trainer", "lr_at_step", "nchw_batch",
           "total_steps"]
