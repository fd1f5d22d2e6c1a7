"""wrench layer."""
