"""The plain references, in plain PyTorch: one module a family of
configurations. Nothing here imports the port, JAX or the JAX package."""
