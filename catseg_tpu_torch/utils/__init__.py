"""Host-side utilities of the port (scalar event logging)."""
