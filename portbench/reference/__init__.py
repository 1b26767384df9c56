"""The plain float32 reference of BaF split inference and its wire
container, in PyTorch and NumPy alone (nothing of the port, no JAX)."""
