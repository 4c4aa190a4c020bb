"""The model class of a ``ModelConfig``: Llama or GPT-NeoX / Pythia.

The JAX package dispatches on ``model_cfg.family`` where it builds a model
(``relora_tpu/serve/engine.py:208-216``, ``relora_tpu/train/trainer.py:154-158``);
the port's engine and trainer call :func:`causal_lm_class` there.  Both
classes are :class:`~relora_tpu_torch.models.llama.CausalLM`: one
constructor and one ``forward``.
"""

from __future__ import annotations

from typing import Type

from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.llama import CausalLM, LlamaForCausalLM
from relora_tpu_torch.models.pythia import GPTNeoXForCausalLM

__all__ = ["CausalLM", "causal_lm_class"]


def causal_lm_class(model_cfg: ModelConfig) -> Type[CausalLM]:
    """``LlamaForCausalLM`` for ``family="llama"``, ``GPTNeoXForCausalLM``
    for ``"neox"``; any other family raises ``ValueError``."""
    if model_cfg.family == "llama":
        return LlamaForCausalLM
    if model_cfg.family == "neox":
        return GPTNeoXForCausalLM
    raise ValueError(f"Unknown model family {model_cfg.family!r}")
