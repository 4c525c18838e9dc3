"""Transformer blocks, the ViT, and the model facade (paged LM decode,
vision training)."""
