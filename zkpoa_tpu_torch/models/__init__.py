"""Circuit-side helpers of the port (the circuit frontend itself is shared)."""
