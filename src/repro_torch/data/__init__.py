"""Input data generators."""
