"""Model configurations of the port (data only)."""
