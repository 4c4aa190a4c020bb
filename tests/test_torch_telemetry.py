"""The port's training telemetry against the JAX package's.

``relora_tpu_torch.obs.mfu`` (the peak table, the counted update FLOPs
against ``torch.utils.flop_counter`` and XLA's cost model),
``obs.memory`` (the per-group bytes and live stats against
``relora_tpu.obs.memory``), ``utils.profiling.StepProfiler`` (its windows
against the JAX profiler's), and ``Trainer.fit``'s ``metrics.jsonl``,
``run_config.json``, spans and flight dump against the JAX trainer's over
the same run, at tiny configs on the CPU.  No assertion reads a wall-clock
share beyond the waterfall's sum, which holds by construction.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.config.training import TrainingConfig as JaxTrainingConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import partition
from relora_tpu.core.schedules import make_schedule as jax_make_schedule
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.obs import memory as jax_memory
from relora_tpu.obs import mfu as jax_mfu
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu.train.trainer import Trainer as JaxTrainer
from relora_tpu.utils import profiling as jax_profiling
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.obs import memory, mfu
from relora_tpu_torch.ops.lora_dispatch import H100_PEAK_FLOPS
from relora_tpu_torch.train.trainer import Trainer, refuse_unported
from relora_tpu_torch.utils import profiling

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=2, max_sequence_length=32)
NEOX = dict(LLAMA, family="neox", rotary_pct=0.25)
# 8 updates of 2 x (4, 16): one merge and one reset, at update 5
RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=8, cycle_length=4, relora=4,
              use_peft=True, lora_r=4, lora_dropout=0.0, eval_every=1000, seed=0)
LOSS_TOL = 1e-4
FLOP_TOL = 0.01  # step_flops against FlopCounterMode
# XLA's cost model counts every op, the elementwise ones too (norms, rotary,
# softmax, AdamW), which step_flops leaves out: ~9% more at this width
XLA_TOL = 0.2
SHARE_SUM_TOL = 1e-3
SHARES = ("data_fetch", "dispatch", "compute", "comms", "host")
# keys of the JAX trainer's records with no counterpart in the port: the
# XLA compile telemetry (obs/compile.py) and XLA's static memory plan
JAX_ONLY_KEYS = {"compile/steady_state_retraces"}
JAX_ONLY_EVENTS = {"compile"}
JAX_ONLY_PLAN_SOURCES = {"xla_train_step"}
JAX_ONLY_SPANS = {"compile"}


def _data_config(tmp_path):
    path = tmp_path / "data.json"
    path.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return str(path)


def _cfg(tmp_path, **kw):
    return TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                          device="cpu", **{**RECIPE, **kw}).finalize()


def _batches(n=8):
    rng = np.random.default_rng(0)
    return ((rng.integers(0, 128, (n, 2, 4, 1)) + np.arange(16)) % 128).astype(np.int32)


def _read(path):
    return [json.loads(line) for line in open(path)]


# ------------------------------------------------------------------ peak FLOPs


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", H100_PEAK_FLOPS),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12),
    ("NVIDIA A100-SXM4-80GB", 312e12),
    ("NVIDIA GeForce RTX 4090", None),
])
def test_peak_flops_table(monkeypatch, name, want):
    """The device name looked up most specific first; the SXM H100 the JAX
    table's h100 entry; a name the table does not know gives None."""
    monkeypatch.delenv("RELORA_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert mfu.peak_flops(torch.device("cuda", 0)) == want
    if name == "NVIDIA H100 80GB HBM3":
        assert want == dict(jax_mfu.PEAK_FLOPS_BY_KIND)["h100"]


def test_peak_flops_env_and_cpu_against_jax(monkeypatch):
    """RELORA_TPU_PEAK_FLOPS wins in both packages.  Without it the CPU
    gives None here, where the JAX package falls back to one TPU v5e's
    197e12: a TPU's rate, not the device's, so the port's MFU is null."""
    monkeypatch.delenv("RELORA_TPU_PEAK_FLOPS", raising=False)
    assert mfu.peak_flops(torch.device("cpu")) is None
    assert mfu.peak_flops() is None  # no CUDA device here
    assert jax_mfu.peak_flops(jax.devices("cpu")[0]) == jax_mfu.PEAK_FLOPS_DEFAULT == 197e12
    monkeypatch.setenv("RELORA_TPU_PEAK_FLOPS", "1.5e15")
    assert mfu.peak_flops(torch.device("cpu")) == jax_mfu.peak_flops(jax.devices("cpu")[0]) == 1.5e15
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_flops(torch.device("cuda", 0)) == 1.5e15


# ------------------------------------------------------------------ step FLOPs


def _one_update_flops(trainer, batch):
    with FlopCounterMode(display=False) as counter:
        trainer._train_step(trainer.state, torch.as_tensor(batch, dtype=torch.long), None)
    return counter.get_total_flops()


def _count(trainer, cfg, attention="naive"):
    return mfu.step_flops(trainer.model_cfg, microbatch=4, seq=16, grad_accum=2,
                          lora_r=cfg.lora_r, lora_only=trainer.lora_spec.lora_only,
                          remat=cfg.remat, attention=attention)


@pytest.mark.parametrize("variant", [
    {}, {"lora_fused": "true"}, {"quantize": "int8"}, {"remat": True},
], ids=["dense", "fused", "int8", "remat"])
@pytest.mark.parametrize("family", [LLAMA, NEOX], ids=["llama", "neox"])
def test_step_flops_equals_the_flop_counter(tmp_path, family, variant):
    """One update on the plain path (the naive attention arm) under
    FlopCounterMode: equal within 1%.  Under remat the checkpoint's recompute
    stops after the last tensor the backward saves, so it skips a layer's
    last product; the count includes it (0.3% here)."""
    cfg = _cfg(tmp_path, **variant)
    trainer = Trainer(cfg, model_cfg=ModelConfig(**family))
    counted = _one_update_flops(trainer, _batches(1)[0])
    want = _count(trainer, cfg)
    assert abs(want / counted - 1) <= FLOP_TOL, (want, counted)
    if not variant.get("remat"):
        assert want == counted


def test_step_flops_counts_the_flash_arm_as_its_kernels_work(tmp_path):
    """The flash arm's plain twins form every (query, key) pair where the
    kernels visit only the causal triangle: FlopCounterMode over them equals
    the flash count plus its nine products over the pairs above the
    diagonal, and the flash arm does three products more than the naive."""
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, model_cfg=ModelConfig(**LLAMA))
    batch = _batches(1)[0]
    naive = _one_update_flops(trainer, batch)
    trainer.model.attention_arm = "flash"
    flash = _one_update_flops(trainer, batch)
    S, B, N, H, L, ga = 16, 4, 2, 16, 2, 2
    per_pair = 2 * B * N * H * L * ga
    above = S * S - S * (S + 1) // 2
    assert flash - naive == 3 * per_pair * S * S
    assert _count(trainer, cfg, "flash") + 9 * per_pair * above == flash


def test_step_flops_against_the_xla_cost_model():
    """The JAX train step's compiled cost at the same config (layers
    unrolled, one microbatch: XLA counts a loop's body once) is the
    port's count plus the elementwise work it leaves out."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0)
    model = JaxLlama(JaxModelConfig(**LLAMA), lora=spec, dtype=jnp.float32, scan_layers=False,
                     attention_impl="naive")
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    mask = jax_relora.trainable_param_mask(params)
    sched = jax_make_schedule("linear", lr=1e-3, num_training_steps=8, warmup_steps=1)
    tx = jax_optim.build_optimizer(schedule=sched)
    state = JaxTrainState.create(params, tx.init(partition(params, mask)[0]))
    step = jax.jit(jax_make_train_step(model, tx, mask, clip_grad_norm=1.0, schedule=sched))
    cost = step.lower(state, jnp.zeros((1, 4, 16), jnp.int32), jax.random.PRNGKey(0)).cost_analysis()
    xla = jax_mfu.step_flops_from_cost_analysis(cost)
    ours = mfu.step_flops(ModelConfig(**LLAMA), microbatch=4, seq=16, grad_accum=1, lora_r=4,
                          attention="naive")
    assert ours <= xla <= (1 + XLA_TOL) * ours, (xla, ours)


# ------------------------------------------------------------------ memory


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_state_breakdown_equals_the_pytree_breakdown(tmp_path, quantize):
    """params_bytes equal to JAX's; opt_state_bytes equal up to the step
    counters: AdamW keeps a 4-byte f32 ``step`` per trainable tensor, optax
    an int32 ``count`` in its Adam state and one in its schedule state."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0, quantize=quantize)
    model = JaxLlama(JaxModelConfig(**LLAMA), lora=spec, dtype=jnp.float32, scan_layers=True,
                     attention_impl="naive")
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    mask = jax_relora.trainable_param_mask(params)
    tx = jax_optim.build_optimizer(schedule=jax_make_schedule("linear", lr=1e-3, num_training_steps=8,
                                                              warmup_steps=1))
    opt_state = tx.init(partition(params, mask)[0])
    want = jax_memory.pytree_breakdown({"params": params, "opt_state": opt_state})
    counters = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(opt_state) if np.ndim(leaf) == 0)
    assert counters == 2 * 4

    trainer = Trainer(_cfg(tmp_path, quantize=quantize), model_cfg=ModelConfig(**LLAMA))
    trainable = [p for p in trainer.model.parameters() if p.requires_grad]
    before = memory.state_breakdown({"params": trainer.model, "opt_state": trainer.optimizer})
    assert before["params_bytes"] == want["params_bytes"]
    steps = memory.ADAM_STEP_BYTES * len(trainable)
    assert before["opt_state_bytes"] - steps == want["opt_state_bytes"] - counters
    assert before["total_bytes"] == before["params_bytes"] + before["opt_state_bytes"]
    # after the first step AdamW holds the state it was counted with
    trainer.fit(iter(_batches(1)))
    assert memory.state_breakdown({"params": trainer.model, "opt_state": trainer.optimizer}) == before


def test_live_memory_stats_schema_equals_jax_on_cpu():
    ours, theirs = memory.live_memory_stats(), jax_memory.live_memory_stats(jax.devices("cpu")[0])
    assert ours == theirs == {"available": False, "bytes_in_use": None, "peak_bytes_in_use": None,
                              "bytes_limit": None}
    assert memory.live_memory_stats(torch.device("cpu")) == ours
    assert memory.MemoryPoller().poll() == ours


# ------------------------------------------------------------------ profiler


def test_step_profiler_windows_fall_on_the_jax_profilers_steps(tmp_path, monkeypatch):
    calls = {"jax": [], "torch": []}
    step = {"jax": 0, "torch": 0}
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: calls["jax"].append(("start", step["jax"])))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls["jax"].append(("stop", step["jax"])))
    monkeypatch.setattr(profiling, "start_trace", lambda: calls["torch"].append(("start", step["torch"])) or "p")
    monkeypatch.setattr(profiling, "stop_trace",
                        lambda prof, path: calls["torch"].append(("stop", step["torch"])))
    theirs = jax_profiling.StepProfiler(str(tmp_path / "jax"))
    ours = profiling.StepProfiler(str(tmp_path / "torch"))
    for i in range(20):
        step["jax"] = step["torch"] = i
        theirs.step()
        ours.step()
    assert calls["torch"] == calls["jax"] == [("start", 2), ("stop", 4), ("start", 7), ("stop", 9)]
    assert len(ours.traces) == 2

    # a window open at close() ends there, in both
    calls["jax"].clear()
    calls["torch"].clear()
    theirs = jax_profiling.StepProfiler(str(tmp_path / "jax"))
    ours = profiling.StepProfiler(str(tmp_path / "torch"))
    for i in range(3):
        step["jax"] = step["torch"] = i
        theirs.step()
        ours.step()
    assert ours.tracing
    step["jax"] = step["torch"] = "close"
    theirs.close()
    ours.close()
    assert calls["torch"] == calls["jax"] == [("start", 2), ("stop", "close")]
    assert not ours.tracing
    ours.close()  # idempotent
    assert len(calls["torch"]) == 2


def test_profile_true_trains_and_writes_chrome_traces(tmp_path, monkeypatch):
    """--profile is no longer refused; an 8-update run writes one whole
    window and the one close() ends, each a Chrome trace of the updates'
    ops."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(tmp_path, profile=True, num_training_steps=8, save_dir=str(tmp_path / "run"))
    refuse_unported(cfg)
    result = Trainer(cfg, model_cfg=ModelConfig(**LLAMA)).fit(iter(_batches(8)))
    assert result["update_step"] == 8
    traces = sorted(glob.glob(str(tmp_path / "profiler_logs" / "run" / "trace_*.json")))
    assert [os.path.basename(t) for t in traces] == ["trace_0.json", "trace_1.json"]
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert "aten::mm" in names


# ------------------------------------------------------------------ the trainer


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer over the 8 updates, log_every 4, spans to a JSONL:
    its initial params, the params after its merge, its metrics.jsonl and
    span names."""
    tmp = tmp_path_factory.mktemp("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("RELORA_TPU_TRACE_DIR", str(tmp / "traces"))
    try:
        cfg = JaxTrainingConfig(dataset_path="/synthetic", dtype="float32", save_dir=str(tmp / "run"),
                                log_every=4, dp_size=1, save_every=1000, **RECIPE).finalize()
        trainer = JaxTrainer(cfg, model_cfg=JaxModelConfig(**LLAMA))
        params = jax.tree_util.tree_map(np.asarray, trainer.state.params)
        merged = []
        merge = trainer._merge_fn

        def spy_merge(p, rng):
            out = merge(p, rng)
            merged.append(jax.tree_util.tree_map(np.asarray, out))
            return out

        trainer._merge_fn = spy_merge
        trainer.fit(iter(_batches()))
    finally:
        mp.undo()
    records = _read(tmp / "run" / "metrics.jsonl")
    spans = {s["name"] for s in _read(tmp / "traces" / "train_spans.jsonl")}
    return {"params": params, "merged": merged, "records": records, "spans": spans}


def _port_run(tmp_path, monkeypatch, jax_run, name, **kw):
    """The port's trainer over the same updates from the JAX trainer's
    initial params, each merge taking the JAX trainer's fresh A."""
    trainer = Trainer(_cfg(tmp_path, save_dir=str(tmp_path / name), **kw), model_cfg=ModelConfig(**LLAMA))
    trainer.model.load_state_dict(params_from_jax(jax_run["params"]))
    queue = []
    for tree in jax_run["merged"]:
        sd = params_from_jax(tree)
        queue.extend(sd[f"{n}.lora_a"] for n, _ in relora.lora_modules(trainer.model))
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    result = trainer.fit(iter(_batches()))
    assert not queue
    return result, _read(tmp_path / name / "metrics.jsonl")


def _steps(records):
    return [r for r in records if "loss" in r and "_event" not in r]


def test_fit_writes_the_jax_trainers_telemetry(tmp_path, monkeypatch, jax_run):
    monkeypatch.setenv("RELORA_TPU_TRACE_DIR", str(tmp_path / "traces"))
    result, records = _port_run(tmp_path, monkeypatch, jax_run, "run", log_every=4)
    theirs = jax_run["records"]

    steps, jax_steps = _steps(records), _steps(theirs)
    assert len(steps) == len(jax_steps) == 8
    for ours, want in zip(steps, jax_steps):
        assert set(want) <= set(ours), set(want) - set(ours)
        assert ours["_source"] == "train" and ours["mfu"] is None  # no peak on the CPU
        assert ours["update_step"] == want["update_step"] and ours["_step"] == want["_step"]
        assert {"update_seconds", "tokens_seen", "n_lora_restarts", "n_optimizer_resets"} <= set(ours)
    np.testing.assert_allclose([r["loss"] for r in steps], [r["loss"] for r in jax_steps],
                               atol=LOSS_TOL, rtol=0)
    assert [r["loss"] for r in steps] == [r["loss"] for r in result["records"]]

    gaps = [r for r in records if "mfu_gap/wall_s" in r]
    jax_gaps = [r for r in theirs if "mfu_gap/wall_s" in r]
    assert len(gaps) == len(jax_gaps) == 2
    for gap, want in zip(gaps, jax_gaps):
        assert set(want) - JAX_ONLY_KEYS <= set(gap)
        assert gap["mfu_gap/window_steps"] == 4 and gap["mfu_gap/comms"] == 0.0
        assert all(gap[f"mfu_gap/{k}"] >= 0 for k in SHARES)
        assert abs(sum(gap[f"mfu_gap/{k}"] for k in SHARES) - 1) <= SHARE_SUM_TOL
        assert "hbm/peak_bytes_in_use" not in gap  # no allocator stats on the CPU

    events = {r["_event"] for r in records if "_event" in r}
    assert events == {r["_event"] for r in theirs if "_event" in r} - JAX_ONLY_EVENTS == {"memory_plan"}
    plans = [r for r in records if r.get("_event") == "memory_plan"]
    jax_plans = [r for r in theirs if r.get("_event") == "memory_plan"
                 and r["source"] not in JAX_ONLY_PLAN_SOURCES]
    assert [p["source"] for p in plans] == [p["source"] for p in jax_plans] == ["pytree"]
    assert set(plans[0]) == set(jax_plans[0])
    assert plans[0]["params_bytes"] == jax_plans[0]["params_bytes"]

    config = json.load(open(tmp_path / "run" / "run_config.json"))
    assert config["log_every"] == 4 and config["model"]["hidden_size"] == 32
    assert config["grad_accum"] == 2

    spans = {s["name"] for s in _read(tmp_path / "traces" / "train_spans.jsonl")}
    assert spans == jax_run["spans"] - JAX_ONLY_SPANS

    report = subprocess.run([sys.executable, os.path.join(REPO, "tools", "perf_report.py"),
                             str(tmp_path / "run"), "--bench-dir", ""],
                            capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stdout + report.stderr
    assert "MFU-gap waterfall" in report.stdout and "per-pytree" in report.stdout


def test_log_every_and_tracing_leave_the_losses_bit_equal(tmp_path, monkeypatch, jax_run):
    """The same run at log_every 4 and 1, tracing on and off: the same
    losses bit for bit, one waterfall record per flush."""
    runs = {}
    for name, log_every, trace in (("every4", 4, False), ("every1", 1, False), ("traced", 4, True)):
        if trace:
            monkeypatch.setenv("RELORA_TPU_TRACE_DIR", str(tmp_path / "traces"))
        else:
            monkeypatch.delenv("RELORA_TPU_TRACE_DIR", raising=False)
        result, records = _port_run(tmp_path, monkeypatch, jax_run, name, log_every=log_every)
        runs[name] = [r["loss"] for r in result["records"]]
        assert [r["loss"] for r in _steps(records)] == runs[name]
        assert len([r for r in records if "mfu_gap/wall_s" in r]) == 8 // log_every
    assert runs["every4"] == runs["every1"] == runs["traced"]


def test_mfu_is_step_flops_over_seconds_and_peak(tmp_path, monkeypatch):
    """With a peak (the env override), each record's mfu is the counted
    update FLOPs over its seconds and the peak; without a peak (the CPU,
    no override) mfu is null and the FLOPs are still counted."""
    monkeypatch.setenv("RELORA_TPU_PEAK_FLOPS", "1e12")
    cfg = _cfg(tmp_path, save_dir=str(tmp_path / "run"))
    trainer = Trainer(cfg, model_cfg=ModelConfig(**LLAMA))
    result = trainer.fit(iter(_batches()))
    assert result["peak_flops"] == 1e12 and result["step_flops"] == _count(trainer, cfg)
    for r in result["records"]:
        assert r["mfu"] == result["step_flops"] / r["update_seconds"] / 1e12
    assert trainer.obs.gauge_value("mfu") == result["records"][-1]["mfu"]

    monkeypatch.delenv("RELORA_TPU_PEAK_FLOPS")
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, model_cfg=ModelConfig(**LLAMA))
    result = trainer.fit(iter(_batches(2)))
    assert result["peak_flops"] is None and result["step_flops"] == _count(trainer, cfg)
    assert [r["mfu"] for r in result["records"]] == [None, None]


def test_a_crash_in_the_loop_leaves_a_flight_dump(tmp_path):
    trainer = Trainer(_cfg(tmp_path, save_dir=str(tmp_path / "run")), model_cfg=ModelConfig(**LLAMA))
    step = trainer._train_step

    def failing(state, batch, seeds):
        if trainer.update_step == 2:
            raise RuntimeError("device lost")
        return step(state, batch, seeds)

    trainer._train_step = failing
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.fit(iter(_batches()))
    dumps = glob.glob(str(tmp_path / "run" / "flight_crash_*.json"))
    assert len(dumps) == 1
    dump = json.load(open(dumps[0]))
    assert dump["reason"] == "crash"
    assert {"update_step", "data_fetch", "dispatch"} <= {s["name"] for s in dump["spans"]}


def test_cli_writes_telemetry_and_a_profile_on_cpu_without_jax(tmp_path):
    """``python -m relora_tpu_torch.main --save_dir D --log_every 4
    --profile true`` in a process without JAX: D/metrics.jsonl with step
    records, an mfu_gap record per flush and the memory_plan event, which
    perf_report renders, and a Chrome trace under profiler_logs/."""
    from test_torch_train import _run_cli

    save_dir = tmp_path / "run"
    _run_cli(tmp_path, ["--save_dir", str(save_dir), "--log_every", "4", "--profile", "true"])
    records = _read(save_dir / "metrics.jsonl")
    steps = _steps(records)
    assert len(steps) == 6
    assert all({"mfu", "throughput_tokens", "throughput_examples", "throughput_batches"} <= set(r)
               for r in steps)
    gaps = [r for r in records if "mfu_gap/wall_s" in r]
    assert [g["mfu_gap/window_steps"] for g in gaps] == [4, 2]
    assert all(abs(sum(g[f"mfu_gap/{k}"] for k in SHARES) - 1) <= SHARE_SUM_TOL for g in gaps)
    assert any(r.get("_event") == "memory_plan" for r in records)
    assert glob.glob(str(tmp_path / "profiler_logs" / "run" / "trace_0.json"))
    report = subprocess.run([sys.executable, os.path.join(REPO, "tools", "perf_report.py"),
                             str(save_dir), "--bench-dir", ""],
                            capture_output=True, text=True, timeout=120)
    assert report.returncode == 0 and "MFU-gap waterfall" in report.stdout
    assert "per-pytree" in report.stdout


def test_raw_record_reader_matches_the_profilers_event_tree():
    """``profiling.kineto_intervals`` and ``busy_ns`` (the one reader of the
    profiler's raw records, behind ``DeviceWindow`` and chip_smoke's device
    profiles) against ``prof.events()`` over a CPU region: the same
    intervals, the same busy time and the same time per op name (the card's
    kernels get the same check in chip_smoke's ``check_profile_readers``)."""
    cpu = torch.autograd.DeviceType.CPU
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            x = torch.softmax(x @ x, dim=-1) + 1e-3
    raw, raw_names = profiling.kineto_intervals(prof, cpu)
    tree, tree_names = [], {}
    for ev in prof.events():
        if ev.device_type == cpu and ev.time_range.elapsed_us() > 0:
            tree.append((ev.time_range.start * 1e3, ev.time_range.end * 1e3))
            tree_names[ev.name[:80]] = tree_names.get(ev.name[:80], 0.0) + ev.time_range.elapsed_us()
    assert raw and len(raw) == len(tree)
    busy = profiling.busy_ns(raw)
    assert abs(busy - profiling.busy_ns(tree)) <= 1e-6 * busy + 1
    assert busy < sum(e - s for s, e in raw)  # nested ops count once
    assert set(raw_names) == set(tree_names)
    assert all(abs(raw_names[k] - tree_names[k]) <= 1e-6 * tree_names[k] + 1e-3 for k in raw_names)
    assert profiling.busy_ns([(0, 10), (5, 20), (30, 40), (32, 35)]) == 30
