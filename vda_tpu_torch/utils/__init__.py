"""Host-side utilities of the port: preprocessing and weights."""
