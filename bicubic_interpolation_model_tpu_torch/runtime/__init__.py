"""Device resolution, the CUDA kernel build and the native image/tensor IO binding."""
