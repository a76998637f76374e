"""The plain reference the benchmark holds the system to."""
