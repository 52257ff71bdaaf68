"""vkvolume_tpu_torch — the PyTorch/CUDA port of the vkvolume_tpu renderer.

Same layout and public names as ``vkvolume_tpu`` (the JAX package, which
stays the reference): host-side numpy modules are copied, device code is
plain PyTorch, and every kernel the JAX package writes in Pallas is a
hand-written CUDA kernel for Hopper (``csrc/``), bound with ctypes and
built by nvcc at its first use. Each kernel wrapper runs its plain PyTorch
version for CPU tensors and the kernel for CUDA tensors.

This package never imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# True-fp32 math everywhere. The JAX package pins "highest" matmul precision
# because a bf16 truncation of the tiny camera matmuls bent ray directions
# enough to break pixel parity (vkvolume_tpu/__init__.py); TF32 is the same
# trap on Hopper (about three decimal digits), in matmuls and in cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
