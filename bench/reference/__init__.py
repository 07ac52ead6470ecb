"""Plain references of the benchmark's models (no code of the program)."""
