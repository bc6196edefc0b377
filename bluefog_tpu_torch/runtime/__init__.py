"""Process-level runtime of the port (lifecycle, ranks, topology)."""
