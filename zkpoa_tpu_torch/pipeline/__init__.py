"""Input preparation and the three-layer workflow of the port."""
