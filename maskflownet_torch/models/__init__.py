from maskflownet_torch.models.maskflownet import (DENSE_CH, HEAD_SCOPE,
                                                  MODELS, PYRAMID_CH,
                                                  STRIDES, ModelConfig,
                                                  build_model, init_params,
                                                  maskflownet_s, param_shapes)

# the cascade's forward is ``models.maskflownet.maskflownet`` (or
# ``build_model("MaskFlownet")``): a package attribute of that name would
# hide the submodule of the same name
__all__ = ["DENSE_CH", "HEAD_SCOPE", "MODELS", "PYRAMID_CH", "STRIDES",
           "ModelConfig", "build_model", "init_params", "maskflownet_s",
           "param_shapes"]
