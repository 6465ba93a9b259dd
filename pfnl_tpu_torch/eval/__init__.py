"""Periodic validation of the port (PFNL family so far)."""
