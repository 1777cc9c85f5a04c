"""Host utilities: image IO, workspace configuration."""
