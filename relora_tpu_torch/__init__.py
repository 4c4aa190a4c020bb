"""PyTorch/CUDA port of relora_tpu for NVIDIA Hopper.

The JAX package ``relora_tpu`` stays the reference; this package imports
``torch`` and numpy only.  Plain tensor code is PyTorch; every kernel that
the JAX package wrote in Pallas is a hand-written CUDA kernel under
``csrc/``, built with nvcc at first use (``ops/_build.py``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA where none is
    available raises: nothing carries on silently on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain versions on the CPU)"
        )
    return device
