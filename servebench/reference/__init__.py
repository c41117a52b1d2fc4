"""Plain PyTorch references, one module per model family; a configuration
file names its own under ``"reference"``.  They import neither ``jax`` nor
the JAX package nor anything of the port."""
