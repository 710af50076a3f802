"""Image operations on torch tensors, batched over a leading image axis."""
