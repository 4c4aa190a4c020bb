"""GLUE fine-tuning in the port against the JAX package's, on the CPU.

``relora_tpu_torch.eval.glue`` (metrics, the loss, ``finetune``),
``LlamaForSequenceClassification`` with ``params_from_jax`` for its tree,
the backbone graft, and ``python -m relora_tpu_torch.run_glue``, held to
``relora_tpu/eval/glue.py`` and the root ``run_glue.py`` at tiny sizes.
``finetune`` without LoRA starts from the JAX init (recorded from the JAX
``finetune``'s own ``init_params``) and takes the same batches: per-update
losses within 1e-4 across warmup and decay, equal metrics and predictions.
With LoRA the dropout draws differ between the packages, so the initial
logits are held to JAX, the port is shown to learn, and both packages are
shown to train the LoRA-wrapped bases (ROADMAP Queue 3 item 8).
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core.relora import LoraSpec as JaxLoraSpec
from relora_tpu.eval import glue as jax_glue
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.llama import LlamaForSequenceClassification as JaxClassifier
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core.relora import LoraSpec
from relora_tpu_torch.eval import glue
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForSequenceClassification

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
TOL = 1e-4
PAD = 0
BS = 8


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------------ metrics

METRICS = ("accuracy", "f1_binary", "matthews_corr", "pearson_corr", "spearman_corr")
TASKS = tuple(jax_glue.TASK_NUM_LABELS) + ("locpair", "locnsp", "custom_regression")


@pytest.mark.parametrize("name", [f"metric:{m}" for m in METRICS] + [f"task:{t}" for t in TASKS])
def test_metrics_equal_jax(name):
    kind, what = name.split(":")
    rng = np.random.default_rng(sum(map(ord, name)))
    preds, labels = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    scores, targets = rng.normal(size=50).astype(np.float32), rng.normal(size=50).astype(np.float32)
    if kind == "metric":
        a, b = (scores, targets) if what in ("pearson_corr", "spearman_corr") else (preds, labels)
        assert getattr(glue, what)(a, b) == getattr(jax_glue, what)(a, b)
        assert getattr(glue, what)(a[:1] * 0, b[:1] * 0) == getattr(jax_glue, what)(a[:1] * 0, b[:1] * 0)
        return
    if what == "custom_regression":
        args = ("mytask", scores, targets, 1)
    elif jax_glue.TASK_NUM_LABELS.get(what) == 1:
        args = (what, scores, targets, None)
    else:
        args = (what, preds, labels, None)
    got, want = glue.task_metrics(*args), jax_glue.task_metrics(*args)
    assert got == want and got
    assert glue.TASK_TO_KEYS == jax_glue.TASK_TO_KEYS and glue.TASK_NUM_LABELS == jax_glue.TASK_NUM_LABELS


@pytest.mark.parametrize("num_labels", [3, 1])
def test_classification_loss_equals_jax(num_labels):
    rng = np.random.default_rng(num_labels)
    logits = rng.normal(size=(6, num_labels)).astype(np.float32)
    labels = rng.normal(size=6).astype(np.float32) if num_labels == 1 else rng.integers(0, 3, 6)
    x = torch.tensor(logits, requires_grad=True)
    got = glue.classification_loss(x, torch.as_tensor(labels), num_labels)
    got.backward()
    loss_fn = lambda l: jax_glue.classification_loss(l, jnp.asarray(labels), num_labels)  # noqa: E731
    want, grad = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ the classifier


def _ids(rows=6, width=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (rows, width)).astype(np.int32)
    for r, n in enumerate(rng.integers(1, width + 1, rows)):
        ids[r, n:] = PAD  # right padding
    return ids


@pytest.mark.parametrize("lora", [False, True], ids=["dense", "lora"])
def test_classifier_logits_equal_jax(lora):
    """Right-padded rows, a pad id mid-row (the JAX rule counts pads,
    wherever they are) and an all-pad row (pooled at position 0); without
    a pad id every row pools at its last position."""
    ids = _ids()
    ids[0, 2] = ids[1, 0] = PAD
    ids[2, :] = PAD
    spec = dict(r=4, alpha=8.0, dropout=0.1)
    params = None
    for pad_token_id in (PAD, None):
        model = JaxClassifier(JaxModelConfig(**TINY), num_labels=3, pad_token_id=pad_token_id,
                              lora=JaxLoraSpec(**spec) if lora else None, dtype=jnp.float32)
        if params is None:
            params = jax_init_params(model, jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32))
            if lora:  # non-zero B, so the branch shows in the logits
                params = jax.tree_util.tree_map_with_path(
                    lambda p, v: v + 0.05 if "lora_b" in jax.tree_util.keystr(p) else v, params)
        want = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
        port = LlamaForSequenceClassification(ModelConfig(**TINY), 3, pad_token_id,
                                              lora=LoraSpec(**spec) if lora else None)
        sd = params_from_jax(_tree(params))
        assert set(sd) == set(port.state_dict()) and "score.weight" in sd
        assert any(k.endswith("lora_b") for k in sd) == lora
        port.load_state_dict(sd)
        with torch.no_grad():
            got = port(torch.as_tensor(ids).long())
        assert got.dtype == torch.float32 and got.shape == (6, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


# ------------------------------------------------------------------ finetune


def _task(n, seed, width=12):
    """Token 1 at position 0 means label 1: a separable task, right-padded."""
    rng = np.random.default_rng(seed)
    ids = _ids(n, width, seed)
    labels = rng.integers(0, 2, n)
    ids[:, 0] = np.where(labels == 1, 1, 2)
    return ids, labels


def _batches(ids, labels, bs=BS):
    return lambda: ((ids[i:i + bs], labels[i:i + bs]) for i in range(0, len(ids) - bs + 1, bs))


def _spy_jax(monkeypatch):
    """Record the JAX ``finetune``'s init, every update's loss and the params
    its first prediction reads."""
    seen = {"losses": []}
    real_init, real_jit = jax_glue.init_params, jax.jit

    def spy_init(*a, **kw):
        seen["init"] = _tree(real_init(*a, **kw))
        return seen["init"]

    def spy_jit(fn=None, **kw):
        if fn is None:
            return lambda f: spy_jit(f, **kw)
        jitted = real_jit(fn, **kw)
        if fn.__name__ == "train_step":
            def train_step(*a):
                out = jitted(*a)
                seen["losses"].append(float(out[2]))
                return out
            return train_step
        if fn.__name__ == "predict":
            def predict(params, ids):
                seen.setdefault("final", _tree(params))
                return jitted(params, ids)
            return predict
        return jitted

    monkeypatch.setattr(jax_glue, "init_params", spy_init)
    monkeypatch.setattr(jax, "jit", spy_jit)
    return seen


def _spy_port(monkeypatch):
    seen = {"losses": []}
    real = glue.build_classifier

    def spy(*a, **kw):
        seen["model"] = real(*a, **kw)
        seen["init"] = {k: v.detach().clone() for k, v in seen["model"].state_dict().items()}
        return seen["model"]

    monkeypatch.setattr(glue, "build_classifier", spy)
    seen["on_step"] = lambda step, loss: seen["losses"].append(loss.item())
    return seen


def _jax_backbone():
    lm = JaxLlama(JaxModelConfig(**TINY), dtype=jnp.float32)
    return _tree(jax_init_params(lm, jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32)))


@pytest.mark.parametrize("grafted", [False, True], ids=["init", "grafted"])
def test_finetune_tracks_jax_without_lora(monkeypatch, grafted):
    train, evals, test = _task(32, 0), _task(16, 1), _task(8, 2)[0]
    gcfg = dict(task="mrpc", lr=5e-3, batch_size=BS, num_epochs=2, warmup_ratio=0.25, seed=3)
    backbone = _jax_backbone() if grafted else None
    args = (_batches(*train), _batches(*evals), len(train[0]) // BS)
    predict = lambda: (test[i:i + BS] for i in range(0, len(test), BS))  # noqa: E731

    theirs = _spy_jax(monkeypatch)
    want_metrics, want_preds = jax_glue.finetune(
        JaxModelConfig(**TINY), jax_glue.GlueConfig(**gcfg), *args, pad_token_id=PAD,
        pretrained_backbone=backbone, predict_batches=predict)
    monkeypatch.undo()
    ours = _spy_port(monkeypatch)
    metrics, preds = glue.finetune(
        ModelConfig(**TINY), glue.GlueConfig(**gcfg), *args, pad_token_id=PAD,
        pretrained_backbone=params_from_jax(backbone) if grafted else None, predict_batches=predict,
        device="cpu", init_state_dict=params_from_jax(theirs["init"]), on_step=ours["on_step"])

    # 8 updates: lr 0 at update 0, warmup to update 2, then the decay to 0
    assert len(ours["losses"]) == len(theirs["losses"]) == 8
    np.testing.assert_allclose(ours["losses"], theirs["losses"], atol=TOL, rtol=0)
    assert metrics == want_metrics and set(metrics) == {"accuracy", "f1"}
    np.testing.assert_array_equal(preds, want_preds)
    final = params_from_jax(theirs["final"])
    for k, v in ours["model"].state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=TOL, rtol=0, err_msg=k)
    if grafted:  # the graft put the backbone's embedding under model.
        np.testing.assert_array_equal(ours["init"]["model.embed_tokens.weight"].numpy(),
                                      backbone["embed_tokens"]["embedding"])


def test_glue_schedule_is_optax_at_its_count():
    import optax

    for total, ratio in ((8, 0.25), (20, 0.06), (3, 0.0), (17, 0.06)):
        w = int(total * ratio)
        want = optax.join_schedules([optax.linear_schedule(0.0, 2e-3, max(1, w)),
                                     optax.linear_schedule(2e-3, 0.0, max(1, total - w))], [w])
        got = glue.glue_schedule(2e-3, total, ratio)
        np.testing.assert_allclose([got(c) for c in range(total + 2)],
                                   [float(want(c)) for c in range(total + 2)], atol=1e-10, rtol=1e-6)


LORA_GLUE = dict(task="sst2", lr=5e-3, batch_size=BS, num_epochs=1, warmup_ratio=0.0, use_lora=True,
                 lora_r=4, seed=2)


@pytest.fixture(scope="module")
def jax_lora_run():
    """The JAX ``finetune`` with ``use_lora`` over two updates: its init and
    the params its evaluation reads."""
    mp = pytest.MonkeyPatch()
    try:
        theirs = _spy_jax(mp)
        train = _task(16, 5)
        jax_glue.finetune(JaxModelConfig(**TINY), jax_glue.GlueConfig(**LORA_GLUE), _batches(*train),
                          _batches(*train), 2, pad_token_id=PAD)
    finally:
        mp.undo()
    return theirs


def test_lora_classifier_starts_from_the_jax_logits(jax_lora_run):
    init = jax_lora_run["init"]
    assert "lora_a" in init["model"]["layers"]["self_attn"]["q_proj"]
    ids = _task(16, 1)[0]
    model = JaxClassifier(JaxModelConfig(**TINY), num_labels=2, pad_token_id=PAD,
                          lora=JaxLoraSpec(r=4, alpha=8, dropout=0.1), dtype=jnp.float32)
    want = np.asarray(model.apply({"params": init}, jnp.asarray(ids)))
    port = glue.build_classifier(ModelConfig(**TINY), 2, PAD, glue.lora_spec_for(glue.GlueConfig(**LORA_GLUE)),
                                 "cpu", init_state_dict=params_from_jax(init))
    with torch.no_grad():
        got = port(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_lora_finetune_learns_the_separable_task():
    gcfg = dict(task="sst2", lr=8e-3, batch_size=32, num_epochs=4, use_lora=True, lora_r=4, seed=1)
    train = _task(128, 4, width=10)
    metrics, _ = glue.finetune(ModelConfig(**TINY), glue.GlueConfig(**gcfg), _batches(*train, bs=32),
                               _batches(*train, bs=32), 4, pad_token_id=PAD, device="cpu")
    assert metrics["accuracy"] > 0.8


def test_lora_finetune_trains_the_base_in_both_packages(monkeypatch, jax_lora_run):
    """The JAX ``finetune`` applies AdamW to the whole tree and its unfused
    LoRA branch leaves the base's gradient on, so GLUE with ``use_lora``
    trains the base; the port does the same, so that the trees agree."""
    train = _task(16, 5)
    ours = _spy_port(monkeypatch)
    glue.finetune(ModelConfig(**TINY), glue.GlueConfig(**LORA_GLUE), _batches(*train), _batches(*train),
                  2, pad_token_id=PAD, device="cpu", init_state_dict=params_from_jax(jax_lora_run["init"]),
                  on_step=ours["on_step"])
    jax_init, jax_final = params_from_jax(jax_lora_run["init"]), params_from_jax(jax_lora_run["final"])
    port_final = ours["model"].state_dict()
    for leaf in ("layers.0.self_attn.q_proj.weight", "layers.1.mlp.down_proj.weight",
                 "layers.0.self_attn.q_proj.lora_a"):
        key = f"model.{leaf}"
        assert not torch.equal(jax_final[key], jax_init[key]), f"JAX left {key} as it was"
        assert not torch.equal(port_final[key], ours["init"][key]), f"the port left {key} as it was"
    assert all(p.requires_grad for p in ours["model"].parameters())
    assert len(ours["losses"]) == 2 and np.isfinite(ours["losses"]).all()


# ------------------------------------------------------------------ run_glue


def _write_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=TINY["vocab_size"], special_tokens=["<unk>", "<pad>"])
    texts = [f"alpha beta gamma {i}" for i in range(50)] + [f"delta epsilon zeta {i}" for i in range(50)]
    tok.train_from_iterator(texts, trainer)
    tok.save(str(path))
    return str(path)


def _write_splits(root, labels=("pos", "neg"), labeled_test=True):
    rows_a = [{"sentence": f"alpha beta gamma {i}", "label": labels[0]} for i in range(24)]
    rows_b = [{"sentence": f"delta epsilon zeta {i}", "label": labels[1]} for i in range(24)]
    splits = {"train": rows_a[:16] + rows_b[:16], "validation": rows_a[16:20] + rows_b[16:20],
              "test": rows_a[20:] + rows_b[20:]}
    paths = {}
    for name, rows in splits.items():
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            for r in rows:
                f.write(json.dumps(r if name != "test" or labeled_test else {"sentence": r["sentence"]}) + "\n")
    return paths


@pytest.fixture(scope="module")
def glue_files(tmp_path_factory):
    """A tokenizer, the splits, the model config and a port checkpoint with
    unmerged LoRA factors."""
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.train.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("glue")
    (root / "model.json").write_text(json.dumps(TINY))
    spec = LoraSpec(r=4, alpha=8.0)
    lm = init_params(LlamaForCausalLM(ModelConfig(**TINY), lora=spec), torch.Generator().manual_seed(9))
    state = {k: v + 0.01 if k.endswith("lora_b") else v for k, v in lm.state_dict().items()}
    ckpt = save_checkpoint(str(root / "ckpt"), 3, state, {"update_step": 3}, lora_spec=spec)
    return {"tok": _write_tokenizer(root / "tok.json"), "model": str(root / "model.json"),
            "ckpt": ckpt, "spec": spec, "state": state, "root": root}


def _glue_argv(files, paths, out, *extra):
    argv = ["--task_name", "synth", "--model_config", files["model"], "--tokenizer", files["tok"],
            "--num_train_epochs", "2", "--per_device_train_batch_size", "8", "--learning_rate", "5e-3",
            "--max_seq_length", "16", "--output_dir", str(out), *extra]
    for name in ("train", "validation", "test"):
        if name in paths:
            argv += [f"--{name}_file", paths[name]]
    return argv


def test_load_backbone_merges_the_checkpoints_factors(glue_files):
    from relora_tpu_torch.core.relora import merged_params
    from relora_tpu_torch.run_glue import load_backbone

    got = load_backbone(glue_files["ckpt"])
    want = merged_params(glue_files["state"], glue_files["spec"])
    assert set(got) == set(want) and not any(k.endswith(("lora_a", "lora_b")) for k in got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


def test_cli_train_eval_predict_in_the_jax_format(tmp_path, glue_files, monkeypatch, capsys):
    """``python -m relora_tpu_torch.run_glue --device cpu`` (run as
    ``__main__`` in this process) from a port checkpoint: train, eval and
    predict, with dynamic padding, into the root ``run_glue.py``'s files:
    ``all_results.json`` with the ``eval_`` prefix, and
    ``predict_results_{task}.txt`` as ``index<TAB>prediction`` lines with
    the label names."""
    import runpy

    paths = _write_splits(tmp_path)
    argv = [*_glue_argv(glue_files, paths, tmp_path / "out", "--do_predict", "true", "--pad_to_max_length",
                        "false"), "--checkpoint", glue_files["ckpt"], "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["relora_tpu_torch.run_glue", *argv])
    runpy.run_module("relora_tpu_torch.run_glue", run_name="__main__")
    got = json.load(open(tmp_path / "out" / "all_results.json"))
    assert set(got) == {"task", "eval_accuracy"} and got["task"] == "synth"
    assert 0.0 <= got["eval_accuracy"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    lines = (tmp_path / "out" / "predict_results_synth.txt").read_text().splitlines()
    assert lines[0] == "index\tprediction" and len(lines) == 9
    assert [line.split("\t")[0] for line in lines[1:]] == [str(i) for i in range(8)]
    assert {line.split("\t")[1] for line in lines[1:]} <= {"pos", "neg"}


def test_cli_predict_only_infers_labels_from_the_validation_split(tmp_path, glue_files):
    from relora_tpu_torch import run_glue

    paths = _write_splits(tmp_path, labels=("yes", "no"), labeled_test=False)
    del paths["train"]
    out = tmp_path / "out"
    run_glue.main(_glue_argv(glue_files, paths, out, "--do_train", "false", "--do_eval", "false",
                             "--do_predict", "true", "--device", "cpu"))
    lines = (out / "predict_results_synth.txt").read_text().splitlines()
    assert lines[0] == "index\tprediction" and len(lines) == 9
    assert {line.split("\t")[1] for line in lines[1:]} <= {"yes", "no"}
    assert json.load(open(out / "all_results.json")) == {"task": "synth"}


def test_cli_infers_regression_from_float_labels(tmp_path, glue_files):
    from relora_tpu_torch import run_glue

    paths = _write_splits(tmp_path, labels=("0.5", "3.3"))
    out = tmp_path / "out"
    result = run_glue.main(_glue_argv(glue_files, paths, out, "--do_predict", "true", "--device", "cpu"))
    assert set(result) == {"task", "eval_pearson", "eval_spearmanr"}
    lines = (out / "predict_results_synth.txt").read_text().splitlines()
    assert all(len(line.split("\t")[1].split(".")[1]) == 3 for line in lines[1:])


def test_cli_refuses_a_dirty_output_dir(tmp_path, glue_files, monkeypatch):
    from relora_tpu_torch import run_glue

    paths = _write_splits(tmp_path)
    (tmp_path / "out").mkdir()
    (tmp_path / "out" / "old.txt").write_text("x")
    monkeypatch.setattr(glue, "finetune", lambda *a, **kw: pytest.fail("fine-tuned into a dirty dir"))
    with pytest.raises(ValueError, match="exists and is not empty"):
        run_glue.main(_glue_argv(glue_files, paths, tmp_path / "out", "--device", "cpu"))
    with pytest.raises(ValueError, match="missing required splits"):
        run_glue.main(_glue_argv(glue_files, {"validation": paths["validation"]}, tmp_path / "new",
                                 "--device", "cpu"))
