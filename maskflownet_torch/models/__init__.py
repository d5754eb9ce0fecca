from maskflownet_torch.models.maskflownet import (DENSE_CH, PYRAMID_CH,
                                                  STRIDES, ModelConfig,
                                                  init_params, maskflownet_s,
                                                  param_shapes)

__all__ = ["DENSE_CH", "PYRAMID_CH", "STRIDES", "ModelConfig", "init_params",
           "maskflownet_s", "param_shapes"]
