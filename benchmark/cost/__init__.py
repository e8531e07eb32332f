"""Operations and bytes from shapes, and the chip's published peaks.

``peaks``: NVIDIA's data-sheet peaks of one H100 SXM. ``stages``: the
fused U-Net stages (K2 contract, K3 expand) of a configuration, their
bytes and FLOPs (chip_smoke.py's ``stage_cost``), and the U-Net's
convolution FLOPs (``mfu``). ``scatter``: the bytes K1 (the
resampler-backward scatter) has to move in a training step.
"""
