"""The training slice as a whole: the port's ``Trainer.fit`` and its CLI.

Per-update loss parity: the port's trainer and the JAX package's train step,
merge and reset, driven under the JAX trainer's cadence rule, from one JAX
init on the tiny llama of ``tests/test_end_to_end.py``, over 6 updates of 2
microbatches with one merge and one reset, at f32 on the CPU, within 1e-4.
The A re-draw at the merge comes from ``jax.random`` in one package and a
``torch.Generator`` in the other, so the test carries the JAX package's
fresh A into the port at the merge; LoRA dropout is off.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import partition
from relora_tpu.core.schedules import make_schedule as jax_make_schedule
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.data.memmap import MemmapTokenWriter
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.train import trainer as trainer_mod
from relora_tpu_torch.train.trainer import Trainer, keyed_generator

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=6, cycle_length=3, relora=3,
              use_peft=True, lora_r=4, lora_dropout=0.0, eval_every=1000, seed=0)
LOSS_TOL = 1e-4


def _data_config(tmp_path):
    path = tmp_path / "data.json"
    path.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return str(path)


def _jax_run(batches):
    """The JAX package's step, merge and reset under the trainer's cadence
    rule; returns per-update losses, the initial params and the fresh A of
    every merge."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0)
    model = JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                     attention_impl="naive")
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    mask = jax_relora.trainable_param_mask(params)
    sched = jax_make_schedule("cosine_restarts", lr=5e-3, num_training_steps=6, warmup_steps=2,
                              cycle_length=3, restart_warmup_steps=1)
    tx = jax_optim.build_optimizer(schedule=sched)
    state = JaxTrainState.create(params, tx.init(partition(params, mask)[0]))
    step = jax.jit(jax_make_train_step(model, tx, mask, clip_grad_norm=1.0, schedule=sched))
    losses, fresh_a = [], []
    for u, batch in enumerate(batches, start=1):
        state, metrics = step(state, jnp.asarray(batch), jax.random.PRNGKey(u))
        losses.append(float(metrics["loss"]))
        if u >= 3 and u % 3 == 1:
            state = state.replace(params=jax_relora.merge_and_reinit(state.params, jax.random.PRNGKey(u), spec))
            fresh_a.append(jax.tree_util.tree_map(np.asarray, state.params))
            state = state.replace(opt_state=jax_optim.reset_optimizer_state(state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), fresh_a


def test_trainer_fit_tracks_jax_loss_per_update(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 128, (6, 2, 4, 1))
    batches = ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1
    want, params, merged_trees = _jax_run(batches)

    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", **RECIPE).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    trainer.model.load_state_dict(params_from_jax(params))
    # the merge re-draws each A: take the JAX package's draw, module by module
    queue = []
    for tree in merged_trees:
        sd = params_from_jax(tree)
        queue.extend(sd[f"{name}.lora_a"] for name, _ in relora.lora_modules(trainer.model))
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    result = trainer.fit(iter(batches))

    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert not queue, "every merge took the JAX draw"
    assert result["update_step"] == 6
    assert (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)
    assert got[-1] < got[0]


def _record_draws(monkeypatch, trainer):
    """Spy on the trainer's three keyed draws; returns ``{kind: {update:
    value}}``: the dropout seeds of each update, the first module's fresh A
    at each merge and the reset generator's state at each reset."""
    draws = {"dropout": {}, "merge_a": {}, "reset": {}}
    step = trainer._train_step

    def spy_step(state, batch, seeds):
        draws["dropout"][trainer.update_step + 1] = list(seeds)
        return step(state, batch, seeds)

    def spy_merge(model, generator, spec, **kw):
        out = real_merge(model, generator, spec, **kw)
        name = next(relora.lora_modules(model))[0]
        draws["merge_a"][trainer.update_step] = model.get_submodule(name).lora_a.detach().clone()
        return out

    def spy_reset(optimizer, model, **kw):
        draws["reset"][trainer.update_step] = kw["generator"].get_state().clone()
        return real_reset(optimizer, model, **kw)

    real_merge, real_reset = trainer_mod.merge_and_reinit, trainer_mod.reset_optimizer_state
    trainer._train_step = spy_step
    monkeypatch.setattr(trainer_mod, "merge_and_reinit", spy_merge)
    monkeypatch.setattr(trainer_mod, "reset_optimizer_state", spy_reset)
    return draws


def test_draws_are_keyed_by_seed_and_update_step(tmp_path, monkeypatch):
    """Dropout seeds, the merge's fresh A and the random-pruning reset's
    generator at update t depend only on (seed, t): a run that reaches t
    straight and a fresh Trainer whose counters start at t - 1 draw the
    same, and t and t + 1 (or the next merge) draw differently."""
    recipe = {**RECIPE, "num_training_steps": 9, "lora_dropout": 0.1,
              "reset_optimizer_on_relora": False, "optimizer_random_pruning": 0.5}
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", **recipe).finalize()
    batches = np.random.default_rng(2).integers(0, 128, (9, 2, 4, 16))
    straight = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    want = _record_draws(monkeypatch, straight)
    straight.fit(iter(batches))
    assert sorted(want["merge_a"]) == sorted(want["reset"]) == [4, 7]

    resumed = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    # the counters as they stood after update 3 (the cadence counts the
    # updates run since the start)
    resumed.update_step, resumed.global_step, resumed._local_updates = 3, 3 * resumed.grad_accum, 3
    got = _record_draws(monkeypatch, resumed)
    resumed.fit(iter(batches[3:]))

    assert sorted(got["dropout"]) == list(range(4, 10))
    for t in range(4, 10):
        assert got["dropout"][t] == want["dropout"][t]
        assert want["dropout"][t] != want["dropout"][t - 1]
        assert len(set(want["dropout"][t])) == len(want["dropout"][t])  # one seed per microbatch
    for t in (4, 7):
        torch.testing.assert_close(got["merge_a"][t], want["merge_a"][t], rtol=0, atol=0)
        assert torch.equal(got["reset"][t], want["reset"][t])
    assert not torch.equal(want["merge_a"][4], want["merge_a"][7])
    assert not torch.equal(want["reset"][4], want["reset"][7])
    for k in (1, 2, 3):
        draw = [torch.rand(8, generator=keyed_generator(k, t, "cpu")) for t in (4, 5, 4)]
        assert torch.equal(draw[0], draw[2]) and not torch.equal(draw[0], draw[1])


def test_trainer_fit_takes_a_rank_past_256(tmp_path):
    """lora_r = 320 with the fused path: the trainer, LoRALinear and the
    fused Function take it (on the CPU through the twins), train, merge and
    reset."""
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", lora_fused="true", **{**RECIPE, "lora_r": 320}).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    module = next(relora.lora_modules(trainer.model))[1]
    assert module.lora_a.shape[-1] == 320 and trainer.lora_spec.fused
    rng = np.random.default_rng(0)
    batches = ((rng.integers(0, 128, (6, 2, 4, 1)) + np.arange(16)) % 128).astype(np.int32)
    result = trainer.fit(iter(batches))
    losses = [r["loss"] for r in result["records"]]
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)


def test_sigterm_stops_at_the_update_boundary(tmp_path):
    """With handle_preemption (the default) a SIGTERM during the run stops
    the loop after the update in flight, reports preempted and skips the
    final eval, as the JAX trainer does without a checkpoint to write."""
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", **RECIPE).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    batches = np.random.default_rng(1).integers(0, 128, (6, 2, 4, 16))

    def stream():
        for i, batch in enumerate(batches):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    result = trainer.fit(stream(), eval_iter_factory=lambda: iter(batches[0]))
    assert result["preempted"] and result["update_step"] == 3
    assert "final_eval_loss" not in result and result["eval_batches"] == 0


@pytest.mark.parametrize("flag,value", [
    ("warmed_up_model", "state/"), ("prng_impl", "rbg"), ("wandb", True), ("tp_size", 2),
])
def test_unported_options_raise(tmp_path, flag, value):
    """Each option raises; a warm start from a JAX checkpoint directory (one
    holding state/) does too, while a pytorch_model.bin or a port checkpoint
    one is ported."""
    if flag == "warmed_up_model":
        (tmp_path / "ckpt" / "state").mkdir(parents=True)
        value = str(tmp_path / "ckpt")
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", **{**RECIPE, flag: value}).finalize()
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(cfg, model_cfg=ModelConfig(**TINY))


def _run_cli(tmp_path, extra=(), twin=("lora_matmul", "fused_lora_forward_plain")):
    """``python -m relora_tpu_torch.main --device cpu`` on a tiny Megatron
    corpus, in a process where importing jax, flax or relora_tpu fails;
    returns the result dict and the number of calls of ``twin`` (module of
    ``relora_tpu_torch.ops``, function), the fused forward twin by default."""
    rng = np.random.default_rng(0)
    with MemmapTokenWriter(str(tmp_path / "corpus"), dtype=np.uint16) as w:
        for _ in range(120):
            w.add_document((rng.zipf(1.3, rng.integers(20, 200)) % 128).astype(np.uint16))
    (tmp_path / "data.json").write_text(json.dumps(
        {"data_path": str(tmp_path / "corpus"), "split": "90,10,0", "seq_length": 16, "seed": 1}))
    (tmp_path / "tiny.json").write_text(json.dumps(TINY))
    args = ["--device", "cpu", "--model_config", str(tmp_path / "tiny.json"),
            "--megatron_dataset_config", str(tmp_path / "data.json"), "--final_eval_tokens", "500"]
    for key in ("batch_size", "total_batch_size", "max_length", "lr", "scheduler", "warmup_steps",
                "restart_warmup_steps", "num_training_steps", "cycle_length", "relora", "lora_r"):
        args += [f"--{key}", str(RECIPE[key])]
    args += ["--use_peft", "true", *extra]
    code = (
        "import json, sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'flax', 'relora_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"import relora_tpu_torch.ops.{twin[0]} as M\n"
        f"calls, twin = [], M.{twin[1]}\n"
        f"M.{twin[1]} = lambda *a: calls.append(1) or twin(*a)\n"
        f"sys.argv = ['relora_tpu_torch.main'] + {args!r}\n"
        "runpy.run_module('relora_tpu_torch.main', run_name='__main__')\n"
        "print(len(calls))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-2])
    assert result["update_step"] == 6
    assert (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)
    assert np.isfinite(result["final_eval_loss"]) and result["eval_batches"] > 0
    return result, int(lines[-1])


def test_cli_trains_on_cpu_without_jax(tmp_path):
    _, fused_calls = _run_cli(tmp_path)
    assert fused_calls == 0


def test_cli_trains_fused_on_cpu_without_jax(tmp_path):
    """``--lora_fused true --lora_dropout 0``: every projection, in training
    and eval, takes the fused path (its plain twins on the CPU)."""
    result, fused_calls = _run_cli(tmp_path, ["--lora_fused", "true", "--lora_dropout", "0"])
    layers = TINY["num_hidden_layers"]
    assert fused_calls == 7 * layers * (2 * 6 + result["eval_batches"])


def test_cli_trains_int8_warm_started_on_cpu_without_jax(tmp_path):
    """``--quantize int8 --warmed_up_model DIR`` from a pytorch_model.bin of
    seeded f32 weights: every projection's base product, in training and
    eval, takes kernel 8's path (its plain twin on the CPU)."""
    dense = LlamaForCausalLM(ModelConfig(**TINY))
    init_params(dense, torch.Generator().manual_seed(7))
    (tmp_path / "warm").mkdir()
    torch.save({f"model.{k}" if k != "lm_head.weight" else k: v for k, v in dense.state_dict().items()},
               tmp_path / "warm" / "pytorch_model.bin")
    result, calls = _run_cli(tmp_path, ["--quantize", "int8", "--warmed_up_model",
                                        str(tmp_path / "warm")], twin=("quant_matmul", "dequant_matmul_plain"))
    assert calls == 7 * TINY["num_hidden_layers"] * (2 * 6 + result["eval_batches"])
