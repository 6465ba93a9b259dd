"""Training of the port (PFNL family so far)."""
