"""Entry points of the port (the JAX package's ``repro.launch``): the
training CLI."""
