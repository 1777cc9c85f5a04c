"""Model loading by checkpoint metadata."""
