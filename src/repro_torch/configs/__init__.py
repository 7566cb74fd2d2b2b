"""Model configurations of the port (a copy of the JAX package's
framework-free ``repro.configs`` modules it needs)."""
