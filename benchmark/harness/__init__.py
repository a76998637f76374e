"""The benchmark harness: traffic loops, generators, trace reduction, checks."""
