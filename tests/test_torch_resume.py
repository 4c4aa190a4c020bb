"""Checkpoints, resume, the emergency save and loss-spike rollback of the
port's trainer, on the CPU at f32, on the tiny llama of
``tests/test_torch_train.py`` over 9 updates of 2 microbatches (merges and
resets at 4 and 7).

A ``Trainer.fit`` cut by SIGTERM while update 5 runs writes an emergency
checkpoint; ``autoresume`` resumes it to update 9 across the merge and reset
at 7, and the two runs give per-update losses, parameters, AdamW state and
counters bit-equal to a straight run: every draw is keyed by ``(seed,
update)``, the checkpoint holds the f32 state exactly, and the data resumes
at the update reached.  The same cut-and-resumed run tracks the JAX
package's step, merge and reset run straight within 1e-4 (the tolerance of
``tests/test_torch_train.py``), the JAX package's fresh A carried into the
port at each merge.  Also ``resume_from``, retention, a corrupt newest
checkpoint skipped, the batch-size guard, save retries, a warm start from a
port checkpoint, ``LossSpikeDetector`` against the JAX package's, and an
injected spike rolled back within the rollback budget.
"""

import json
import os
import signal

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
from relora_tpu.train.resilience import LossSpikeDetector as JaxLossSpikeDetector
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.train import checkpoint as ckpt
from relora_tpu_torch.train.resilience import LossSpikeDetector
from relora_tpu_torch.train.trainer import TRAINING_CONFIG_FILE, Trainer

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=9, cycle_length=3, relora=3,
              use_peft=True, lora_r=4, lora_dropout=0.0, eval_every=1000, seed=0)
LOSS_TOL = 1e-4
CUT = 5  # the update SIGTERM arrives in


def _batches(n=9):
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 128, (n, 2, 4, 1))
    return ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1


def _cfg(tmp_path, **kw):
    path = tmp_path / "data.json"
    path.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return TrainingConfig(megatron_dataset_config=str(path), dtype="float32", device="cpu",
                          **{**RECIPE, **kw}).finalize()


def _trainer(tmp_path, **kw):
    return Trainer(_cfg(tmp_path, **kw), model_cfg=ModelConfig(**TINY))


def _losses(result):
    return [r["loss"] for r in result["records"]]


def _cut(batches, at=CUT):
    """The batches, with SIGTERM sent while update ``at`` runs."""
    for i, batch in enumerate(batches):
        if i == at - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        yield batch


def _assert_same_state(a: Trainer, b: Trainer):
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for key in sa["state"]:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][key][field], sb["state"][key][field]), (key, field)
    for field in ("update_step", "global_step", "tokens_seen", "n_lora_restarts",
                  "n_optimizer_resets", "scheduler_start_step"):
        assert getattr(a, field) == getattr(b, field), field
    assert (a.state.step, a.state.n_skipped) == (b.state.step, b.state.n_skipped)


def _cut_and_resume(tmp_path, batches, save_dir, **kw):
    first = _trainer(tmp_path, save_dir=save_dir, save_every=3, keep_checkpoints=2, **kw)
    cut = first.fit(_cut(batches))
    resumed_trainer = _trainer(tmp_path, save_dir=save_dir, save_every=3, keep_checkpoints=2,
                               autoresume=True, **kw)
    resumed = resumed_trainer.fit(iter(batches[resumed_trainer.update_step:]))
    return first, cut, resumed_trainer, resumed


def test_cut_and_resumed_run_is_bit_equal_to_a_straight_run(tmp_path):
    batches = _batches()
    straight = _trainer(tmp_path)
    want = straight.fit(iter(batches))
    save_dir = str(tmp_path / "ckpt")
    _, cut, resumed_trainer, resumed = _cut_and_resume(tmp_path, batches, save_dir)

    assert cut["preempted"] and cut["update_step"] == CUT and "final_eval_loss" not in cut
    assert resumed_trainer.resume_dir == os.path.join(save_dir, f"model_{CUT}")
    assert resumed_trainer._resumed and resumed["update_step"] == 9
    assert _losses(cut) + _losses(resumed) == _losses(want)
    assert (resumed["n_lora_restarts"], resumed["n_optimizer_resets"]) == (2, 2)
    _assert_same_state(straight, resumed_trainer)
    # saves at 3 (cadence), 5 (emergency), 9 (cadence); the newest two kept
    assert sorted(d for d in os.listdir(save_dir) if d.startswith("model_")) == ["model_5", "model_9"]
    assert os.path.exists(os.path.join(save_dir, TRAINING_CONFIG_FILE))
    ts = ckpt.load_training_state(os.path.join(save_dir, "model_9"))
    assert ts["update_step"] == 9 and ts["scheduler_start_step"] == 0 and ts["n_lora_restarts"] == 2
    # metrics.jsonl: both runs' memory plans, the SIGTERM and the emergency
    # save at the cut, then every update's record once
    records = _metrics(save_dir)
    assert [(e["_event"], e["_step"]) for e in records if "_event" in e] == [
        ("memory_plan", 0), ("preemption", CUT), ("emergency_checkpoint", CUT), ("memory_plan", CUT)]
    emergency = next(e for e in records if e.get("_event") == "emergency_checkpoint")
    assert emergency["path"] == os.path.join(save_dir, f"model_{CUT}")
    assert next(e for e in records if e.get("_event") == "preemption")["signum"] == signal.SIGTERM
    assert [r["loss"] for r in records if "loss" in r] == _losses(want)


def _metrics(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_run(batches):
    """The JAX package's step, merge and reset under the trainer's cadence
    rule, straight; returns per-update losses, the initial params and the
    params right after each merge (whose A is the fresh draw)."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0)
    model = JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                     attention_impl="naive")
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    mask = jax_relora.trainable_param_mask(params)
    sched = jax_make_schedule("cosine_restarts", lr=5e-3, num_training_steps=9, warmup_steps=2,
                              cycle_length=3, restart_warmup_steps=1)
    tx = jax_optim.build_optimizer(schedule=sched)
    state = JaxTrainState.create(params, tx.init(partition(params, mask)[0]))
    step = jax.jit(jax_make_train_step(model, tx, mask, clip_grad_norm=1.0, schedule=sched))
    losses, merged = [], []
    for u, batch in enumerate(batches, start=1):
        state, metrics = step(state, jnp.asarray(batch), jax.random.PRNGKey(u))
        losses.append(float(metrics["loss"]))
        if u >= 3 and u % 3 == 1:
            state = state.replace(params=jax_relora.merge_and_reinit(state.params, jax.random.PRNGKey(u), spec))
            merged.append(jax.tree_util.tree_map(np.asarray, state.params))
            state = state.replace(opt_state=jax_optim.reset_optimizer_state(state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), merged


def test_resumed_losses_track_the_jax_straight_run(tmp_path, monkeypatch):
    batches = _batches()
    want, params, merged = _jax_run(batches)
    queue = []
    names = [name for name, _ in relora.lora_modules(_trainer(tmp_path).model)]
    for tree in merged:  # the merges at 4 (cut run) and 7 (resumed run) take JAX's fresh A
        sd = params_from_jax(tree)
        queue.extend(sd[f"{name}.lora_a"] for name in names)
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    save_dir = str(tmp_path / "ckpt")
    first = _trainer(tmp_path, save_dir=save_dir)
    first.model.load_state_dict(params_from_jax(params))
    cut = first.fit(_cut(batches))
    resumed_trainer = _trainer(tmp_path, save_dir=save_dir, autoresume=True)
    resumed = resumed_trainer.fit(iter(batches[CUT:]))
    assert not queue, "both merges took the JAX draw"
    np.testing.assert_allclose(_losses(cut) + _losses(resumed), want, atol=LOSS_TOL, rtol=0)


def test_resume_from_a_named_checkpoint_with_and_without_its_optimizer(tmp_path):
    batches = _batches()
    save_dir = str(tmp_path / "ckpt")
    straight = _trainer(tmp_path, save_dir=save_dir, save_every=3)
    want = straight.fit(iter(batches))
    assert sorted(d for d in os.listdir(save_dir) if d.startswith("model_")) == [
        "model_3", "model_6", "model_9"]
    target = os.path.join(save_dir, "model_3")
    full = _trainer(tmp_path, resume_from=target)
    assert full.update_step == 3 and full._resumed
    got = full.fit(iter(batches[3:]))
    assert _losses(got) == _losses(want)[3:]
    _assert_same_state(straight, full)

    fresh = _trainer(tmp_path, resume_from=target, load_optimizer_state_on_resume=False)
    assert not fresh.optimizer.state and (fresh.state.step, fresh.state.n_skipped) == (3, 0)
    got = fresh.fit(iter(batches[3:]))
    # a fresh AdamW, the schedule where the checkpoint left it
    assert [r["lr"] for r in got["records"]] == [r["lr"] for r in want["records"]][3:]
    assert _losses(got)[0] == _losses(want)[3]  # the same params before the first new update


def test_retention_and_the_last_checkpoint_ignore_uncommitted_and_corrupt_dirs(tmp_path, caplog):
    save_dir = str(tmp_path / "ckpt")
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    for step in (2, 4, 6):
        ckpt.save_checkpoint(save_dir, step, sd, {"update_step": step})
    os.makedirs(os.path.join(save_dir, "model_8"))  # cut off before its manifest
    torch.save(sd, os.path.join(save_dir, "model_8", ckpt.PARAMS_FILE))
    assert ckpt.get_last_checkpoint(save_dir)[1] == os.path.join(save_dir, "model_6")
    assert ckpt.get_last_checkpoint(save_dir, before_step=6)[1] == os.path.join(save_dir, "model_4")
    assert ckpt.get_last_checkpoint(save_dir, before_step=2) == (None, None)
    with open(os.path.join(save_dir, "model_6", ckpt.PARAMS_FILE), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    ts, path = ckpt.get_last_checkpoint(save_dir)
    assert path == os.path.join(save_dir, "model_4") and ts == {"update_step": 4}
    assert "Skipping corrupt checkpoint" in caplog.text
    ckpt.delete_old_checkpoints(save_dir, keep=1)
    assert sorted(os.listdir(save_dir)) == ["model_6", "model_8"]  # model_8 never counted
    ckpt.delete_old_checkpoints(save_dir, keep=None)
    assert sorted(os.listdir(save_dir)) == ["model_6", "model_8"]


def test_autoresume_falls_back_past_a_corrupt_newest_checkpoint(tmp_path):
    batches = _batches()
    save_dir = str(tmp_path / "ckpt")
    straight = _trainer(tmp_path, save_dir=save_dir, save_every=3, num_training_steps=9)
    want = straight.fit(iter(batches))
    os.remove(os.path.join(save_dir, "model_9", ckpt.OPTIMIZER_FILE))
    with pytest.raises(ValueError, match="corrupt"):
        _trainer(tmp_path, resume_from=os.path.join(save_dir, "model_9"))
    resumed = _trainer(tmp_path, save_dir=save_dir, save_every=3, autoresume=True)
    assert resumed.resume_dir == os.path.join(save_dir, "model_6")
    got = resumed.fit(iter(batches[6:]))
    assert _losses(got) == _losses(want)[6:]


def test_resume_refuses_another_batch_size(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    _trainer(tmp_path, save_dir=save_dir, num_training_steps=3).fit(iter(_batches(3)))
    with open(os.path.join(save_dir, TRAINING_CONFIG_FILE)) as f:
        assert json.load(f)["batch_size"] == 4
    with pytest.raises(RuntimeError, match="different batch size"):
        _trainer(tmp_path, save_dir=save_dir, autoresume=True, batch_size=2)
    # a fresh save_dir has nothing to resume: autoresume starts from zero
    assert _trainer(tmp_path, save_dir=str(tmp_path / "empty"), autoresume=True).update_step == 0


def test_a_failed_save_is_retried_then_abandoned_without_stopping_the_run(tmp_path, monkeypatch):
    real = torch.save
    failures = {"left": 1}

    def flaky(obj, path, *args, **kwargs):
        if failures["left"]:
            failures["left"] -= 1
            raise OSError("disk hiccup")
        return real(obj, path, *args, **kwargs)

    monkeypatch.setattr(ckpt.torch, "save", flaky)
    save_dir = str(tmp_path / "ckpt")
    trainer = _trainer(tmp_path, save_dir=save_dir, save_retry_backoff=0.0, num_training_steps=3)
    trainer.fit(iter(_batches(3)))
    assert failures["left"] == 0 and ckpt.verify_checkpoint(os.path.join(save_dir, "model_3"))[0]

    failures["left"] = 10**6
    trainer = _trainer(tmp_path, save_dir=str(tmp_path / "lost"), save_retries=2,
                       save_retry_backoff=0.0, save_every=2, num_training_steps=3)
    result = trainer.fit(iter(_batches(3)))
    assert result["update_step"] == 3 and not result["aborted"]
    # two saves (the cadence's at 2, the final one at 3), three attempts each
    assert failures["left"] == 10**6 - 2 * 3
    assert ckpt.get_last_checkpoint(str(tmp_path / "lost")) == (None, None)
    failed = [e for e in _metrics(str(tmp_path / "lost")) if e.get("_event") == "save_failed"]
    assert [e["_step"] for e in failed] == [2, 3] and all("disk hiccup" in e["error"] for e in failed)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_warm_start_from_a_port_checkpoint(tmp_path, quantize):
    """The base of a port checkpoint grafted by name (an int8 one's codes
    and scales as they are), the LoRA factors fresh, the counters taken."""
    save_dir = str(tmp_path / "ckpt")
    source = _trainer(tmp_path, save_dir=save_dir, num_training_steps=6, quantize=quantize)
    if quantize:
        with torch.no_grad():  # real codes: a fresh int8 base is all zero
            for _, module in relora.lora_modules(source.model):
                module.weight_q.copy_(torch.randint(-127, 128, module.weight_q.shape))
    source.fit(iter(_batches(6)))
    path = os.path.join(save_dir, "model_6")
    saved = ckpt.restore_params_host(path)
    warm = _trainer(tmp_path, warmed_up_model=path, quantize=quantize)
    fresh = _trainer(tmp_path, quantize=quantize)
    for name, p in warm.model.state_dict().items():
        want = fresh.model.state_dict()[name] if relora.is_lora_name(name) else saved[name]
        assert torch.equal(p, want), name
    # the counters come from the checkpoint's training_state.json
    assert (warm.update_step, warm.scheduler_start_step) == (6, 6) and not warm._resumed


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_loss_spike_detector_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 120
    losses = 4.0 * np.exp(-np.arange(n) / 60) + rng.normal(0, 0.02, n)
    for at in rng.choice(np.arange(20, n - 5), 4, replace=False):
        losses[at: at + rng.integers(1, 5)] += rng.uniform(0.3, 3.0)
    losses[rng.integers(20, n)] = np.nan
    kw = dict(window=int(rng.integers(16, 40)), min_history=int(rng.integers(4, 16)),
              patience=int(rng.integers(1, 4)))
    ours, theirs = LossSpikeDetector(3.0, **kw), JaxLossSpikeDetector(3.0, **kw)
    events = 0
    for step, loss in enumerate(losses.tolist(), start=1):
        a, b = ours.update(step, loss), theirs.update(step, loss)
        assert (a is None) == (b is None), step
        if a is not None:
            events += 1
            assert (a.first_step, a.last_step, a.loss, a.median, a.mad) == (
                b.first_step, b.last_step, b.loss, b.median, b.mad)
            ours.reset_streak()
            theirs.reset_streak()
        assert np.isnan(ours.last_median) == np.isnan(theirs.last_median)
        if not np.isnan(ours.last_median):
            assert (ours.last_median, ours.last_mad) == (theirs.last_median, theirs.last_mad)
    assert events > 0


def test_an_injected_spike_rolls_back_and_respects_the_budget(tmp_path):
    batches = _batches(15)
    save_dir = str(tmp_path / "ckpt")
    trainer = _trainer(tmp_path, save_dir=save_dir, save_every=2, num_training_steps=15,
                       spike_threshold=3.0, spike_window=8, spike_min_history=4,
                       spike_patience=2, spike_rollback_margin=1, max_spike_rollbacks=1)
    step = trainer._train_step
    spiked = []

    def spiking(state, batch, seeds):
        metrics = step(state, batch, seeds)
        logged = trainer.update_step + 1
        if logged in (7, 8, 12, 13) and logged not in spiked:
            spiked.append(logged)
            metrics = {**metrics, "loss": metrics["loss"] + 50.0}
        return metrics

    trainer._train_step = spiking
    result = trainer.fit(iter(batches), train_iter_factory=lambda: iter(batches[trainer.update_step:]))
    # updates 7 and 8 spike: back to model_6 (model_8 was saved after the
    # spike began), batch indices 6..8 blacklisted; 12 and 13 spike with the
    # budget spent, so they are logged and training goes on
    assert result["n_rollbacks"] == 1 and trainer.n_spike_rollbacks == 1
    assert {6, 7, 8} <= trainer.cfg.skip_batches and not {11, 12} & trainer.cfg.skip_batches
    assert spiked == [7, 8, 12, 13] and result["update_step"] == 15
    steps = [r["update_step"] for r in result["records"]]
    assert steps == [1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15]
    ts = ckpt.load_training_state(os.path.join(save_dir, "model_15"))
    assert ts["n_spike_rollbacks"] == 1 and {6, 7, 8} <= set(ts["skip_batches"])
    # metrics.jsonl: the spike, the rollback to model_6, the blacklisted
    # batches skipped, the second spike logged with the budget spent
    events = [e for e in _metrics(save_dir) if "_event" in e and e["_event"] != "memory_plan"]
    assert [(e["_event"], e["_step"]) for e in events] == [
        ("loss_spike", 8), ("rollback", 6), ("batch_skipped", 6), ("batch_skipped", 7),
        ("batch_skipped", 8), ("loss_spike", 13), ("rollback_skipped", 13)]
    assert (events[0]["first_step"], events[0]["last_step"]) == (7, 8)
    assert events[1]["target"] == os.path.join(save_dir, "model_6")
    assert events[1]["skip_batches"] == [6, 7, 8] and events[1]["n_spike_rollbacks"] == 1
    assert "budget exhausted" in events[-1]["reason"]
    # a resumed run inherits the blacklist and the spent budget
    resumed = _trainer(tmp_path, save_dir=save_dir, autoresume=True, num_training_steps=15)
    assert {6, 7, 8} <= resumed.cfg.skip_batches and resumed.n_spike_rollbacks == 1
