"""The harness: inputs from the seed, the cells' windows, the trace reduction and the comparison."""
