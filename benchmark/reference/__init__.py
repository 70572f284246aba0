"""Plain references of the benchmark's configurations: float32 PyTorch with
TF32 off, written from the published architectures. Nothing here imports
the program under test, JAX, or the JAX package."""
