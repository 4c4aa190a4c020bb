"""PyTorch/CUDA port of relora_tpu for NVIDIA Hopper.

The JAX package ``relora_tpu`` stays the reference; this package imports
``torch`` and numpy only.  Plain tensor code is PyTorch; every kernel that
the JAX package wrote in Pallas is a hand-written CUDA kernel under
``csrc/``, built with nvcc at first use (``ops/_build.py``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.

Importing the package itself loads no torch: the fleet front end
(``serve/supervisor.py``, ``serve/router.py``, ``serve/autoscale.py``,
``obs/fleet.py``, ``obs/slo.py``) runs in a process that must stay
responsive while its replicas hold the card, and never imports it.
"""


def resolve_device(device):
    """The ``torch.device`` an entry point runs on.  Asking for CUDA where
    none is available raises: nothing carries on silently on the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain versions on the CPU)"
        )
    return device
