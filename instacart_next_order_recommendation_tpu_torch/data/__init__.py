"""Training data: no-duplicates batching (the processed datasets come from
the JAX package's data prep)."""
