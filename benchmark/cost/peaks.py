"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit; a card set below it runs slower, so a share is read with
the card's power limit beside it)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16 / fp16
         "float16": 989e12,
         "float32": 67e12}      # float32 outside the tensor cores
