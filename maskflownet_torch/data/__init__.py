from maskflownet_torch.data import chairs, codecs, paths, synthetic
from maskflownet_torch.data.device_cache import DeviceBatchCache
from maskflownet_torch.data.loader import Dataset, TrainLoader, with_mask
from maskflownet_torch.data.resize import resize_bilinear_np

__all__ = ["Dataset", "DeviceBatchCache", "TrainLoader", "chairs", "codecs",
           "paths", "resize_bilinear_np", "synthetic", "with_mask"]
