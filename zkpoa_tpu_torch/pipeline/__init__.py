"""Input preparation of the port."""
