"""oracle layer."""
