"""util layer."""
