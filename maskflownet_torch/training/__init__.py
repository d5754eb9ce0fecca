from maskflownet_torch.training.engine import (TrainSettings, Trainer,
                                               nchw_batch, sync_metrics)
from maskflownet_torch.training.logging import (DictMovingAverage, FileLog,
                                                MovingAverage, NullLog,
                                                find_checkpoints, find_log,
                                                generate_run_id, read_log)
from maskflownet_torch.training.schedule import lr_at_step, total_steps

__all__ = ["DictMovingAverage", "FileLog", "MovingAverage", "NullLog",
           "TrainSettings", "Trainer", "find_checkpoints", "find_log",
           "generate_run_id", "lr_at_step", "nchw_batch", "read_log",
           "sync_metrics", "total_steps"]
