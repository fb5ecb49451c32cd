"""Model code of the port: layer primitives, the dense decoder family, and
the converter from the JAX package's parameter pytree."""
