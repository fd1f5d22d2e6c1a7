"""frame layer."""
