"""Checkpoint IO (loading; training waits for a later slice)."""
