"""The decoder LM of the serving slice, with parameters in JAX layouts."""
