"""PyTorch/CUDA port of the BaF split-inference pipeline.

The JAX package ``repro`` is the reference; this package keeps its module
names and public (B, H, W, C) layout and imports nothing of it. Entry
points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``.
"""
