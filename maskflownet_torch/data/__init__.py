from maskflownet_torch.data import (chairs, codecs, hd1k, kitti, paths,
                                    sintel, synthetic, things3d)
from maskflownet_torch.data.device_cache import DeviceBatchCache
from maskflownet_torch.data.loader import Dataset, TrainLoader, with_mask
from maskflownet_torch.data.resize import resize_bilinear_np

__all__ = ["Dataset", "DeviceBatchCache", "TrainLoader", "chairs", "codecs",
           "hd1k", "kitti", "paths", "resize_bilinear_np", "sintel",
           "synthetic", "things3d", "with_mask"]
