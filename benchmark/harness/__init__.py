"""The benchmark harness of the PyTorch port: cells, traffic, tracing and
the arithmetic of its metrics."""
