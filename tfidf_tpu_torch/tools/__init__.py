"""Development tools of the port (static analysis and runtime witnesses)."""
