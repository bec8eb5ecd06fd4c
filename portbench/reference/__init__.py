"""The plain reference of the cells' models: numpy and plain torch, f32
with TF32 off, imports nothing of the port or of JAX."""
