"""GLUE fine-tuning of pretrained checkpoints: the engine of
``relora_tpu_torch.run_glue`` (``relora_tpu/eval/glue.py``'s counterpart).

The task table, the five metrics (accuracy, binary F1, Matthews, Pearson,
Spearman: NumPy, no ``evaluate``), the classification loss and
:func:`finetune`, which fine-tunes
:class:`~relora_tpu_torch.models.llama.LlamaForSequenceClassification` and
evaluates it.  As in the JAX package:

- the model is f32; every causal self-attention goes through
  ``ops.attention.dot_product_attention`` (kernel 3's f32 kernels on CUDA);
- ``use_lora`` wraps the backbone's projections with ``LoraSpec(r,
  alpha=2r, dropout=0.1)``, ``fused`` at its default (False), so training
  runs the unfused branch with dropout;
- AdamW (β 0.9 / 0.999, ε 1e-8, decoupled decay) trains every parameter
  of the tree, the LoRA-wrapped bases too: the JAX ``finetune`` applies
  ``optax.adamw`` to the whole tree without a mask, and its unfused branch
  does not stop the base's gradient (ROADMAP Queue 3 item 8);
- the rate is a linear warmup from 0 over ``int(total * warmup_ratio)``
  updates then a linear decay to 0, read at optax's count: update 0 runs at
  ``schedule(0)``;
- evaluation and prediction run without dropout.

LoRA dropout draws from seeds, not from ``jax.random``, so a run with
``use_lora`` follows the JAX run only in law.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from relora_tpu_torch import resolve_device
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core.relora import LoraSpec

logger = logging.getLogger(__name__)

TASK_TO_KEYS: Dict[str, Tuple[str, Optional[str]]] = {
    "cola": ("sentence", None),
    "mnli": ("premise", "hypothesis"),
    "mrpc": ("sentence1", "sentence2"),
    "qnli": ("question", "sentence"),
    "qqp": ("question1", "question2"),
    "rte": ("sentence1", "sentence2"),
    "sst2": ("sentence", None),
    "stsb": ("sentence1", "sentence2"),
    "wnli": ("sentence1", "sentence2"),
}

TASK_NUM_LABELS = {
    "cola": 2, "mnli": 3, "mrpc": 2, "qnli": 2, "qqp": 2,
    "rte": 2, "sst2": 2, "stsb": 1, "wnli": 2,
}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float((preds == labels).mean())


def f1_binary(preds: np.ndarray, labels: np.ndarray) -> float:
    tp = float(((preds == 1) & (labels == 1)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)


def matthews_corr(preds: np.ndarray, labels: np.ndarray) -> float:
    tp = float(((preds == 1) & (labels == 1)).sum())
    tn = float(((preds == 0) & (labels == 0)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0


def pearson_corr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64) - a.mean()
    b = b.astype(np.float64) - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def spearman_corr(a: np.ndarray, b: np.ndarray) -> float:
    def rank(x):
        return np.argsort(np.argsort(x)).astype(np.float64)

    return pearson_corr(rank(a), rank(b))


def task_metrics(
    task: str, preds: np.ndarray, labels: np.ndarray, num_labels: Optional[int] = None
) -> Dict[str, float]:
    """The metric set ``evaluate.load("glue", task)`` reports.  ``num_labels
    == 1`` marks a custom regression task, which reports Pearson and
    Spearman as stsb does."""
    if task == "stsb" or num_labels == 1:
        return {
            "pearson": pearson_corr(preds, labels),
            "spearmanr": spearman_corr(preds, labels),
        }
    if task == "cola":
        return {"matthews_correlation": matthews_corr(preds, labels)}
    out = {"accuracy": accuracy(preds, labels)}
    # pair tasks report accuracy + F1 (GLUE's mrpc/qqp set, and the local
    # pair-shaped surrogates locpair/locnsp)
    if task in ("mrpc", "qqp", "locpair", "locnsp"):
        out["f1"] = f1_binary(preds, labels)
    return out


# ---------------------------------------------------------------------------
# fine-tuning engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GlueConfig:
    task: str = "sst2"
    lr: float = 2e-5
    batch_size: int = 32
    num_epochs: int = 3
    max_length: int = 128
    weight_decay: float = 0.01
    warmup_ratio: float = 0.06
    seed: int = 0
    use_lora: bool = False
    lora_r: int = 8
    # custom (non-GLUE) datasets: an explicit label count; None = the task table's
    num_labels: Optional[int] = None


def classification_loss(logits: torch.Tensor, labels: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Mean cross-entropy for classification, mean squared error for
    regression (``num_labels == 1``)."""
    if num_labels == 1:
        return torch.mean(torch.square(logits[:, 0] - labels.float()))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def glue_schedule(lr: float, total_steps: int, warmup_ratio: float) -> Callable[[int], float]:
    """The rate at optax's update count: ``optax.join_schedules`` of a
    linear 0 -> ``lr`` over ``max(1, warmup)`` updates and a linear ``lr``
    -> 0 over ``max(1, total - warmup)``, joined at ``warmup = int(total *
    warmup_ratio)``."""
    warmup = int(total_steps * warmup_ratio)
    rise, fall = max(1, warmup), max(1, total_steps - warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * min(count, rise) / rise
        return lr - lr * min(max(count - warmup, 0), fall) / fall

    return schedule


def lora_spec_for(gcfg: GlueConfig) -> Optional[LoraSpec]:
    """The classifier's LoRA spec: ``LoraSpec(r, alpha=2r, dropout=0.1)``
    with ``use_lora``, else None."""
    if not gcfg.use_lora:
        return None
    return LoraSpec(r=gcfg.lora_r, alpha=2 * gcfg.lora_r, dropout=0.1)


def build_classifier(
    model_cfg: ModelConfig,
    num_labels: int,
    pad_token_id: Optional[int],
    lora: Optional[LoraSpec],
    device,
    *,
    seed: int = 0,
    init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    pretrained_backbone: Optional[Mapping[str, torch.Tensor]] = None,
):
    """The f32 classifier on ``device``: drawn by ``init_params`` from
    ``seed`` (or loaded from ``init_state_dict``), then the base weights of
    ``pretrained_backbone`` (a causal LM's state dict in the port's names,
    ``lm_head`` dropped) grafted under ``model``
    (``models/warm_start.graft_base_weights``)."""
    from relora_tpu_torch.models.llama import LlamaForSequenceClassification
    from relora_tpu_torch.models.params_util import init_params

    with torch.device(device):
        model = LlamaForSequenceClassification(
            model_cfg, num_labels, pad_token_id, lora=lora, dtype=torch.float32
        )
    if init_state_dict is None:
        init_params(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(init_state_dict)
    if pretrained_backbone is not None:
        from relora_tpu_torch.models.warm_start import graft_base_weights

        backbone = {k: v for k, v in pretrained_backbone.items() if k != "lm_head.weight"}
        graft_base_weights(model.model, backbone)
        logger.info("grafted pretrained backbone into the classifier")
    return model


def finetune(
    model_cfg: ModelConfig,
    gcfg: GlueConfig,
    train_batches: Callable[[], Iterator[Tuple[np.ndarray, np.ndarray]]],
    eval_batches: Callable[[], Iterator[Tuple[np.ndarray, np.ndarray]]],
    steps_per_epoch: int,
    pad_token_id: int = 0,
    pretrained_backbone: Optional[Mapping[str, torch.Tensor]] = None,
    predict_batches: Optional[Callable[[], Iterator[np.ndarray]]] = None,
    do_train: bool = True,
    do_eval: bool = True,
    *,
    device="cuda",
    init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
):
    """Fine-tune and return ``(metrics, predictions)``.

    ``train_batches`` / ``eval_batches`` yield ``(input_ids, labels)`` NumPy
    pairs (``train_batches`` is called once an epoch); ``predict_batches``
    (if given) yields unlabeled ``input_ids`` and gives the predictions.
    ``pretrained_backbone`` is a causal LM's state dict whose base weights
    are grafted under the classifier's ``model``: how a ReLoRA-pretrained
    checkpoint is evaluated downstream.  ``init_state_dict`` (the
    classifier's state dict) replaces the port's own seeded draw.
    ``on_step(step, loss)`` is called after each update with the loss
    tensor, on the device."""
    from relora_tpu_torch.core.optim import build_optimizer, set_lr
    from relora_tpu_torch.train.trainer import fold_in

    device = resolve_device(device)
    num_labels = gcfg.num_labels or TASK_NUM_LABELS[gcfg.task]
    lora = lora_spec_for(gcfg)
    model = build_classifier(
        model_cfg, num_labels, pad_token_id, lora, device, seed=gcfg.seed,
        init_state_dict=init_state_dict, pretrained_backbone=pretrained_backbone,
    )
    schedule = glue_schedule(gcfg.lr, steps_per_epoch * gcfg.num_epochs, gcfg.warmup_ratio)
    optimizer = build_optimizer(model.parameters(), weight_decay=gcfg.weight_decay)

    def to_device(array, dtype=None):
        return torch.as_tensor(np.asarray(array), device=device, dtype=dtype)

    step = 0
    if do_train:
        for epoch in range(gcfg.num_epochs):
            for ids, labels in train_batches():
                label_dtype = torch.float32 if num_labels == 1 else torch.long
                seed = fold_in(gcfg.seed + 1, step) if lora is not None else None
                logits = model(to_device(ids, torch.long), dropout_seed=seed)
                loss = classification_loss(logits, to_device(labels, label_dtype), num_labels)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                set_lr(optimizer, schedule(step))
                optimizer.step()
                if on_step is not None:
                    on_step(step, loss.detach())
                step += 1
            if step:
                logger.info(f"epoch {epoch}: last train loss {loss.item():.4f}")

    @torch.no_grad()
    def predict(ids) -> np.ndarray:
        logits = model(to_device(ids, torch.long)).cpu().numpy()
        return logits[:, 0] if num_labels == 1 else np.argmax(logits, axis=-1)

    metrics: Dict[str, float] = {}
    if do_eval:
        preds, labels_all = [], []
        for ids, labels in eval_batches():
            preds.append(predict(ids))
            labels_all.append(labels)
        metrics = task_metrics(gcfg.task, np.concatenate(preds), np.concatenate(labels_all),
                               num_labels=num_labels)
        logger.info(f"{gcfg.task}: {metrics}")

    predictions = None
    if predict_batches is not None:
        predictions = np.concatenate([predict(ids) for ids in predict_batches()])
    return metrics, predictions
