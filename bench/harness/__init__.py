"""The benchmark's own arithmetic: files by name, weights, FLOPs, traces
and the comparison."""
