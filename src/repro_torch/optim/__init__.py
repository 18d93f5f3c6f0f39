"""The optimizer: AdamW over nested dicts of tensors."""
