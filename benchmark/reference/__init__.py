"""Plain NumPy and PyTorch references that judge the program's outputs.
Nothing here imports the program, JAX or the JAX package."""
