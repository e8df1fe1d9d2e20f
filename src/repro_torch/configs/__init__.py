"""Model configurations of the port."""
