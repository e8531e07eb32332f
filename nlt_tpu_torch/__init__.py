"""nlt_tpu_torch: the PyTorch/CUDA port of nlt_tpu for NVIDIA Hopper.

The module layout and names follow nlt_tpu's, so each module's
counterpart is found by path (``nlt_tpu_torch/models/nlt.py`` ports
``nlt_tpu/models/nlt.py``). Public functions keep nlt_tpu's NHWC
activations and HWIO conv kernels, and the params tree keeps its
nesting, so ``convert.params_from_jax`` is a near-identity.

The package imports torch and never jax or nlt_tpu. Entry points
(``trainvali``, ``nlt_test``, ``serve`` and its ``Server`` and
``ExportedServer``, ``models.nlt.Model``) run on ``device="cuda"``
unless the caller names another device; without CUDA they raise.

Ported so far: serving (``serve.Server`` over ``models.nlt.Model``,
with the device input cache and ``torch.export`` bundles), test-time
inference (``nlt_test``), the training step (``parallel/train.py``:
the flagship recipe's barron + LPIPS, AMSGrad and cached statics, and
nlt_tpu's other training options: the norms, remat, SSIM and E-LPIPS)
and the training entry point (``trainvali``), with the fused U-Net stage
kernels of ``ops/fused_stage.py``, the resampler-backward scatter of
``ops/scatter.py`` and the conv stage of ``ops/conv_stage.py`` written
in CUDA C++ (``csrc/fused_stage.cu`` and the split routes
``csrc/contract_split.cu`` and ``csrc/expand_split.cu``;
``csrc/scatter.cu``; ``csrc/conv_stage.cu``).
"""

import torch


def resolve_device(device):
    """torch.device for an entry point; raises when CUDA is asked for
    and absent (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nlt_tpu_torch: device %r requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path" % str(device))
    return device
