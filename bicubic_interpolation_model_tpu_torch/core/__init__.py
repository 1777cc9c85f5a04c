"""Host-side (NumPy, float64) interpolation kernels and axis plans."""
