"""Core BaF modules: quantization, tiling, BaF prediction, split restore, wire codec."""
