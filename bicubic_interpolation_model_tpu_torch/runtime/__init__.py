"""Device resolution and the CUDA kernel build."""
