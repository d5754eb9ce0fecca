"""Dense-matching ops of the port (NCHW): correlation with its CUDA
kernel, bilinear warping, flow-guided deformable conv, resampling."""
