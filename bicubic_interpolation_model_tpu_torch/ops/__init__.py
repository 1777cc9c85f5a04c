"""Ops: learned-pipeline ops and the CUDA kernel wrappers."""
