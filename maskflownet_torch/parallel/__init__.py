from maskflownet_torch.parallel.mesh import DevicePrefetcher

__all__ = ["DevicePrefetcher"]
