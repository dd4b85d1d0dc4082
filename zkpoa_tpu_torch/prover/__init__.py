"""Groth16 setup, proving and CLI of the port."""
