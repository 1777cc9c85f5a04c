"""Performance harness and benchmark suite."""
