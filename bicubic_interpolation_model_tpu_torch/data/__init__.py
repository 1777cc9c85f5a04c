"""Data formats: the header-prefixed float32 tensor files."""
