"""Model functions of the port: pure functions over dicts of tensors."""
