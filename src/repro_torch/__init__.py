"""PyTorch/CUDA port of ``repro`` (parallel GP regression, pPITC first).

The package mirrors ``repro``'s module paths so that a parity test can import
``repro.X`` and ``repro_torch.X`` side by side. It imports neither JAX nor
anything of ``repro``.

Importing it turns TF32 off for float32 matrix products and for cuDNN: the
K_SD products of the local summaries keep only about three decimal digits in
TF32, which would break the float32 tolerances the port is held to.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
