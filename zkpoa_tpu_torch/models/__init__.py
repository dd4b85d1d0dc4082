"""The port's copy of the circuit frontend (R1CS builder, layer circuits, gadgets)."""
