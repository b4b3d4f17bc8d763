"""The harness: the benchmark's loading of cells, inputs, drivers, traces,
counts and output check."""
