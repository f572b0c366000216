"""The harness: the registry of cells, the loops that drive the system
under test, the trace reader and the comparison with the reference."""
