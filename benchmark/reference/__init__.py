"""The plain float32 reference of the benchmark.

Written from the published recipe (``nlt/config/*.ini`` of
google/neural-light-transport; Barron's general robust loss, arXiv
1701.03077; LPIPS's AlexNet distance; optax's ``scale_by_amsgrad``), in
plain PyTorch, float32, with TF32 off. It imports nothing of the
measured program (``nlt_tpu_torch``), of the JAX package or of JAX,
and takes none of the program's tensors: the benchmark hands it the
same seeded weights and wire-format inputs it hands the program, and
it works out everything else (the observation pyramid, the training
target, the loss, the gradients, the optimizer's update) itself.

``model.py``: the dual U-Net, the resample to camera space and the
uint8 packing. ``losses.py``: the Barron image loss and LPIPS.
``optim.py``: AMSGrad. ``precision.py``: the rounding the control
applies in place of float32 (float8 e4m3 at the points where the
configuration's bfloat16 rounds).
"""
