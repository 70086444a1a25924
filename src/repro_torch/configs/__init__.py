"""Model configurations the port serves (copies of the JAX package's
``configs`` modules of the same names)."""
