"""Ops: the fused U-Net stage kernels, the resampler and its backward
scatter (with their build), and the robust loss's math."""
