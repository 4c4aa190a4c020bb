"""Packaging (parity: reference setup.py — pip-installable package).

The native dataset helpers (relora_tpu/data/native/helpers.cpp) are compiled
at first use with g++ (see native/build hook in __init__.py), so no build
step is required at install time.
"""

from setuptools import find_packages, setup

setup(
    name="relora_tpu",
    version="0.1.0",
    description=(
        "TPU-native ReLoRA pretraining: high-rank training through low-rank "
        "updates on JAX/XLA/pallas/pjit"
    ),
    packages=find_packages(
        include=["relora_tpu", "relora_tpu.*", "relora_tpu_torch", "relora_tpu_torch.*"]
    ),
    package_data={
        "relora_tpu.data.native": ["helpers.cpp"],
        "relora_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pyyaml",
        "einops",
    ],
    extras_require={
        "data": ["datasets", "transformers", "tokenizers"],
        "dev": ["pytest", "chex"],
    },
)
