"""The plain reference the benchmark judges the port by.  It imports
neither ``jax``, the JAX package nor anything of the port."""
