"""Configurations of the port (copies of the reference's config modules)."""
