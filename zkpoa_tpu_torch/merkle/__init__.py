"""Poseidon-Merkle engine of the port."""
