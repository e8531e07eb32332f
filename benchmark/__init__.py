"""The benchmark of nlt_tpu_torch on an NVIDIA H100 (README.md)."""
