"""Ops: the fused U-Net stage kernels and their build, the resampler."""
