"""Models on torch tensors: parameters are plain dicts of tensors."""
