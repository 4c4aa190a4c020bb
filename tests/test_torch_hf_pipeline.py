"""The HF data path of the port against the JAX package's, on the CPU.

``relora_tpu_torch.data.hf_pipeline`` (chunked ids, batch arrays, the
streaming packer), ``python -m relora_tpu_torch.pretokenize`` against the
root ``pretokenize.py``, and ``relora_tpu_torch.main --dataset_path``
against the root ``main.py``: per-update losses within 1e-4 over a merge,
from the JAX trainer's initial params with the JAX trainer's fresh A at the
merge (LoRA dropout off), for a saved ``DatasetDict`` and for a single
dataset that both split with the same seeded ``train_test_split``.  The
tokenizer is trained in place and every dataset is written from seeded
text, so nothing is downloaded.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
# 6 updates of 2 microbatches of 4 x 16 tokens: one merge and one reset, at update 4
RECIPE = ["--batch_size", "4", "--total_batch_size", "8", "--max_length", str(SEQ), "--lr", "5e-3",
          "--scheduler", "cosine_restarts", "--warmup_steps", "2", "--restart_warmup_steps", "1",
          "--num_training_steps", "6", "--cycle_length", "3", "--relora", "3", "--use_peft", "true",
          "--lora_r", "4", "--lora_dropout", "0", "--dtype", "float32", "--eval_every", "1000",
          "--seed", "0", "--dp_size", "1"]
LOSS_TOL = 1e-4
WORDS = "the quick brown fox jumps over lazy dog pack my box with five dozen liquor jugs".split()


@pytest.fixture(scope="module")
def tokenizer_path(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=200, special_tokens=["<unk>", "<|endoftext|>"])
    tok.train_from_iterator([" ".join(WORDS[i:] + WORDS[:i]) for i in range(len(WORDS))] * 4, trainer)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def tokenizer(tokenizer_path):
    from relora_tpu_torch.pretokenize import load_tokenizer

    return load_tokenizer(tokenizer_path)


def _docs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"text": " ".join(rng.choice(WORDS, rng.integers(3, 12)))} for _ in range(n)]


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    import datasets

    path = tmp_path_factory.mktemp("raw") / "docs"
    datasets.Dataset.from_list(_docs(1000)).save_to_disk(str(path))
    return str(path)


def _model_json(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture(scope="module")
def port_cli(tmp_path_factory, raw_dir, tokenizer_path):
    """One process where JAX and ``relora_tpu`` cannot be imported: with
    ``datasets``, ``transformers`` and ``tokenizers`` blocked too, every new
    module imports and a call that needs one of them names it; then, with
    those three back, ``python -m relora_tpu_torch.pretokenize`` writes the
    documents' blocks and ``python -m relora_tpu_torch.main --dataset_path
    --device cpu`` trains on them.  Returns the save dir and the result."""
    root = tmp_path_factory.mktemp("port_cli")
    pretok = ["--dataset", raw_dir, "--tokenizer", tokenizer_path, "--sequence_length", str(SEQ),
              "--num_proc", "1", "--save_dir", str(root / "port")]
    train = ["--model_config", _model_json(root), "--dataset_path", str(root / "port"), *RECIPE,
             "--device", "cpu"]
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'flax', 'relora_tpu'):\n"
        "    sys.modules[name] = None\n"
        "hf = ('datasets', 'transformers', 'tokenizers')\n"
        "for name in hf:\n"
        "    sys.modules[name] = None\n"
        "import relora_tpu_torch.main, relora_tpu_torch.pretokenize, relora_tpu_torch.run_glue\n"
        "import relora_tpu_torch.data.hf_pipeline, relora_tpu_torch.eval.glue\n"
        "for call, name in ((lambda: relora_tpu_torch.pretokenize.main(['--dataset', 'x', '--tokenizer',"
        " 'y', '--save_dir', 'z']), 'datasets'), (lambda: relora_tpu_torch.run_glue.load_tokenizer('t5'),"
        " 'transformers')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert name in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(name)\n"
        "for name in hf:\n"
        "    del sys.modules[name]\n"
        "for module, argv in (('relora_tpu_torch.pretokenize', %r), ('relora_tpu_torch.main', %r)):\n"
        "    sys.argv = [module] + argv\n"
        "    runpy.run_module(module, run_name='__main__')\n"
    ) % (pretok, train)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return str(root / "port"), json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def pretokenized(tmp_path_factory, raw_dir, tokenizer_path, port_cli):
    """The port's save dir and the root ``pretokenize.py``'s over the same
    documents."""
    import pretokenize as jax_pretokenize

    ref = str(tmp_path_factory.mktemp("jax_pretokenize") / "jax")
    jax_pretokenize.main(["--dataset", raw_dir, "--tokenizer", tokenizer_path, "--sequence_length",
                          str(SEQ), "--num_proc", "1", "--save_dir", ref])
    return port_cli[0], ref


def test_tokenize_and_chunk_ids_equal_jax(tokenizer):
    import datasets

    from relora_tpu.data import hf_pipeline as jax_hf
    from relora_tpu_torch.data import hf_pipeline

    ds = datasets.Dataset.from_list(_docs(40, seed=1))
    got = hf_pipeline.tokenize_and_chunk(ds, tokenizer, sequence_length=8, num_proc=1)
    want = jax_hf.tokenize_and_chunk(ds, tokenizer, sequence_length=8, num_proc=1)
    assert len(got) > 0 and got[:]["input_ids"] == want[:]["input_ids"]
    assert got.column_names == want.column_names == ["input_ids"]


@pytest.mark.parametrize("kw", [
    dict(microbatch=2, grad_accum=3),
    dict(microbatch=4, grad_accum=None),
    dict(microbatch=2, grad_accum=2, skip_updates=2),
    dict(microbatch=2, grad_accum=2, process_index=1, process_count=2),
    dict(microbatch=3, grad_accum=None, drop_last=False),
], ids=["train", "eval", "skip_updates", "process_1_of_2", "keep_last"])
def test_token_batch_iterator_equals_jax(kw):
    import datasets

    from relora_tpu.data.hf_pipeline import TokenBatchIterator as JaxIterator
    from relora_tpu_torch.data.hf_pipeline import TokenBatchIterator

    ids = np.random.default_rng(2).integers(0, 1000, (37, SEQ)).tolist()
    ds = datasets.Dataset.from_dict({"input_ids": ids})
    got, want = TokenBatchIterator(ds, **kw), JaxIterator(ds, **kw)
    assert len(got) == len(want) > 0
    got_arrays, want_arrays = list(got), list(want)
    assert len(got_arrays) == len(want_arrays) == len(got)
    for a, b in zip(got_arrays, want_arrays):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_streaming_iterator_equals_jax(tokenizer):
    import datasets

    from relora_tpu.data.hf_pipeline import StreamingTokenIterator as JaxStream
    from relora_tpu_torch.data.hf_pipeline import StreamingTokenIterator

    ds = datasets.Dataset.from_list(_docs(60, seed=3))
    for kw in (dict(), dict(process_index=1, process_count=2)):
        args = dict(sequence_length=8, microbatch=2, grad_accum=2, **kw)
        got = list(StreamingTokenIterator(ds, tokenizer, **args))
        want = list(JaxStream(ds, tokenizer, **args))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_pretokenize_cli_equals_the_root_cli(pretokenized):
    import datasets

    port, ref = pretokenized
    got, want = datasets.load_from_disk(port), datasets.load_from_disk(ref)
    assert len(got) > 40 and got[:]["input_ids"] == want[:]["input_ids"]
    assert all(len(row) == SEQ for row in got[:]["input_ids"])
    got_args, want_args = (json.load(open(os.path.join(d, "args.json"))) for d in pretokenized)
    assert got_args.pop("save_dir") == port and want_args.pop("save_dir") == ref
    assert got_args == want_args and got_args["n_sequences"] == len(got)


def _dataset_dir(tmp_path, source, layout):
    """``layout`` "split": the single dataset of ``source``; "dict": a
    ``DatasetDict`` of its seeded ``train_test_split`` (``main.py:79``), so
    that ``main.py`` trains and evaluates on the same rows in either branch.
    Both with ``source``'s args.json."""
    import datasets

    ds = datasets.load_from_disk(source)
    path = tmp_path / layout
    if layout == "dict":
        split = ds.train_test_split(test_size=min(2000, max(2, len(ds) // 100)), seed=0)
        datasets.DatasetDict({"train": split["train"], "validation": split["test"]}).save_to_disk(str(path))
    else:
        ds.save_to_disk(str(path))
    with open(os.path.join(source, "args.json")) as f:
        (path / "args.json").write_text(f.read())
    return str(path)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, pretokenized):
    """The root ``main.py --dataset_path`` over the single dataset: its
    trainer's initial params, its merge's output, its per-update losses and
    its result.  The "dict" layout holds the same split, so this run is the
    reference of both branches."""
    import jax

    import main as jax_main
    from relora_tpu.train.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("jax_main")
    mp = pytest.MonkeyPatch()
    seen = {"merged": []}
    jax_fit = JaxTrainer.fit

    def spy_fit(self, *a, **kw):
        seen["params"] = jax.tree_util.tree_map(np.asarray, self.state.params)
        merge = self._merge_fn

        def spy_merge(p, rng):
            out = merge(p, rng)
            seen["merged"].append(jax.tree_util.tree_map(np.asarray, out))
            return out

        self._merge_fn = spy_merge
        return jax_fit(self, *a, **kw)

    try:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        mp.setenv("RELORA_TPU_LIVE_MFU", "0")
        mp.setattr(JaxTrainer, "fit", spy_fit)
        data = _dataset_dir(tmp, pretokenized[0], "split")
        seen["result"] = jax_main.main(["--model_config", _model_json(tmp), "--dataset_path", data, *RECIPE,
                                        "--save_dir", str(tmp / "run"), "--save_every", "1000"])
    finally:
        mp.undo()
    records = [json.loads(line) for line in open(tmp / "run" / "metrics.jsonl")]
    seen["losses"] = [r["loss"] for r in records if "loss" in r and "_event" not in r]
    assert len(seen["losses"]) == 6 and len(seen["merged"]) == 1
    return seen


@pytest.mark.parametrize("layout", ["dict", "split"])
def test_dataset_path_training_tracks_jax(tmp_path, monkeypatch, pretokenized, jax_run, layout):
    from relora_tpu_torch import main as port_main
    from relora_tpu_torch.core import relora
    from relora_tpu_torch.models.convert import params_from_jax
    from relora_tpu_torch.train.trainer import Trainer

    port_fit = Trainer.fit

    def spy_fit(self, *a, **kw):
        self.model.load_state_dict(params_from_jax(jax_run["params"]))
        sd = params_from_jax(jax_run["merged"][0])
        queue = [sd[f"{n}.lora_a"] for n, _ in relora.lora_modules(self.model)]
        monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
        out = port_fit(self, *a, **kw)
        assert not queue, "the merge took the JAX draw"
        return out

    monkeypatch.setattr(Trainer, "fit", spy_fit)
    data = _dataset_dir(tmp_path, pretokenized[0], layout)
    result = port_main.main(["--model_config", _model_json(tmp_path), "--dataset_path", data, *RECIPE,
                             "--device", "cpu"])
    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, jax_run["losses"], atol=LOSS_TOL, rtol=0)
    assert result["update_step"] == 6 and result["n_lora_restarts"] == 1
    assert result["eval_batches"] > 0
    np.testing.assert_allclose(result["final_eval_loss"], jax_run["result"]["final_eval_loss"],
                               atol=LOSS_TOL, rtol=0)


def test_sequence_length_guard_raises(tmp_path, pretokenized):
    from relora_tpu_torch import main as port_main

    data = _dataset_dir(tmp_path, pretokenized[0], "split")
    argv = ["--model_config", _model_json(tmp_path), "--dataset_path", data, *RECIPE, "--device", "cpu"]
    argv[argv.index("--max_length") + 1] = str(2 * SEQ)
    with pytest.raises(ValueError, match=f"sequence_length={SEQ}, but max_length={2 * SEQ}"):
        port_main.main(argv)


def test_cli_imports_without_hf_packages_and_trains_without_jax(port_cli, jax_run):
    """The fixture's process: the imports, the named errors, then the two
    CLIs; its run trains the single dataset (the port's own init)."""
    result = port_cli[1]
    assert result["update_step"] == 6 and result["n_lora_restarts"] == 1
    assert result["eval_batches"] > 0 and np.isfinite(result["final_eval_loss"])
    assert result["tokens_seen"] == jax_run["result"]["tokens_seen"]
