"""Continuous deployment in the port, held to the JAX package where both
answer the same question (``tests/test_deploy.py:107-440`` on the port):

- ``checkpoint_step`` and the ``latest`` pointer equal the reference's (each
  package reads the other's pointer); the trainer publishes it only at a
  checkpoint's manifest commit, and other saves never move it;
- the watcher never hands an unverified directory to its callback, remembers
  a bad one until it changes, and retries a rollout that reported failure;
- ``reload_params`` on the live weights is token-identical, other weights
  change the output and swap back, and a bad state dict is refused with the
  live weights untouched;
- ``/admin/reload`` swaps between decode rounds with no request dropped and
  drops the prefix pages of the old weights, a refused checkpoint answers
  422 and an injected apply failure (``deploy_reload``) fails closed;
- the rolling updater refuses a partial fleet, a canary divergence rolls the
  whole fleet back while every in-flight request finishes, and a crash
  mid-update (``deploy_crash_mid_update``) converges on a plain rerun.

Servers bind loopback port 0 on threads of their own; waits are on events
or state with 60 s timeouts, never fixed sleeps.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from relora_tpu.serve import deploy as jax_deploy
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.serve import deploy
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.sampling import SamplingParams
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_llama import CACHE, CHUNK, PAGE, TINY, jax_params
from tests.test_torch_resume import _trainer
from tests.test_torch_server import Served, generate, health, http

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]


@pytest.fixture
def armed(monkeypatch):
    from relora_tpu_torch.utils import faults

    monkeypatch.delenv("RELORA_TPU_REPLICA_ID", raising=False)
    faults.reset()
    yield faults
    faults.reset()


def build_engine():
    return InferenceEngine(ModelConfig(**TINY), params_from_jax(jax_params()), device="cpu",
                           cache_size=CACHE, page_size=PAGE, num_pages=3 * (CACHE // PAGE) + 1,
                           chunk_size=CHUNK)


@pytest.fixture(scope="module")
def engine():
    return build_engine()


@pytest.fixture(scope="module")
def engine_b():
    return build_engine()


def host_tree(engine):
    return {k: v.detach().clone() for k, v in engine.model.state_dict().items()}


def perturb(tree, seed):
    """Other weights: additive noise on every tensor (a uniform scale would
    cancel under RMSNorm and leave greedy output unchanged)."""
    rng = np.random.RandomState(seed)
    return {k: v + torch.as_tensor(rng.normal(scale=0.1, size=tuple(v.shape)), dtype=v.dtype)
            for k, v in tree.items()}


def greedy(engine, prompt, n=8):
    return engine.generate([prompt], max_new_tokens=n, sampling=SamplingParams(temperature=0.0),
                           eos_id=-1)[0]


# -- the pointer and the watcher -------------------------------------------------------------


@pytest.mark.parametrize("path", ["/a/b/model_32", "model_0", "/a/b/model_32/", "/a/notacheckpoint",
                                  "/a/b/model_x", "/a/b/model_", "modelling_7", "x/model-3"])
def test_checkpoint_step_matches_jax(path):
    assert deploy.checkpoint_step(path) == jax_deploy.checkpoint_step(path)


def test_publish_and_read_latest_atomic(tmp_path):
    save_dir = str(tmp_path)
    target = tmp_path / "model_16"
    target.mkdir()
    pointer = deploy.publish_latest(save_dir, str(target))
    assert pointer == str(tmp_path / deploy.LATEST_FILE)
    assert deploy.read_latest(save_dir) == str(target) == jax_deploy.read_latest(save_dir)
    record = json.loads((tmp_path / deploy.LATEST_FILE).read_text())
    assert record["path"] == "model_16" and record["step"] == 16
    jax_deploy.publish_latest(save_dir, str(target))  # the reference's pointer reads the same
    assert deploy.read_latest(save_dir) == str(target)
    assert not os.path.exists(pointer + ".tmp")
    for torn in ('{"path": "mod', json.dumps({"path": "../evil"}), json.dumps([1]),
                 json.dumps({"path": ""})):
        (tmp_path / deploy.LATEST_FILE).write_text(torn)
        assert deploy.read_latest(save_dir) is None  # absent, never an error
    assert deploy.read_latest(str(tmp_path / "nowhere")) is None


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=gen), "b": torch.randn(3, generator=gen)}


def test_trainer_publishes_latest_at_manifest_commit(tmp_path, monkeypatch):
    save_dir = str(tmp_path / "ckpt")
    seen = []
    real = deploy.publish_latest

    def spy(where, path):
        # the pointer moves only once the manifest has committed the directory
        seen.append((os.path.exists(os.path.join(path, ckpt.MANIFEST_FILE)),
                     ckpt.verify_checkpoint(path)))
        return real(where, path)

    monkeypatch.setattr(deploy, "publish_latest", spy)
    ckpt.save_checkpoint(save_dir, 3, _state(), {"update_step": 3})  # not a trainer save
    assert deploy.read_latest(save_dir) is None and not seen
    trainer = _trainer(tmp_path, save_dir=save_dir)
    path = trainer.save()
    assert path == ckpt.checkpoint_dir(save_dir, 0)
    assert seen == [(True, (True, "ok"))]
    assert deploy.read_latest(save_dir) == os.path.abspath(path)
    assert jax_deploy.read_latest(save_dir) == os.path.abspath(path)
    path = ckpt.save_checkpoint(save_dir, 7, _state(1), {"update_step": 7}, publish=True)
    assert deploy.read_latest(save_dir) == os.path.abspath(path) and len(seen) == 2


def _corrupt_params(path):
    target = os.path.join(path, ckpt.PARAMS_FILE)
    with open(target, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    return target


def test_watcher_never_acts_on_unverified_dirs(tmp_path):
    save_dir = str(tmp_path)
    accepted, rejected = [], []
    watcher = deploy.CheckpointWatcher(save_dir, accepted.append,
                                       on_reject=lambda path, reason: rejected.append((path, reason)))
    assert watcher.poll_once() is None  # no pointer yet
    path = ckpt.save_checkpoint(save_dir, 16, _state(), {"update_step": 16}, publish=True)
    bad = _corrupt_params(path)
    assert watcher.poll_once() is None
    assert accepted == [] and len(rejected) == 1
    assert os.path.basename(bad) in rejected[0][1]  # the reason names the file
    assert watcher.poll_once() is None and len(rejected) == 1  # unchanged: not re-verified
    good = ckpt.save_checkpoint(save_dir, 24, _state(1), {"update_step": 24}, publish=True)
    assert watcher.poll_once() == os.path.abspath(good) and accepted == [os.path.abspath(good)]
    assert watcher.poll_once() is None and len(accepted) == 1  # current: no re-fire
    newer = ckpt.save_checkpoint(save_dir, 32, _state(2), {"update_step": 32}, publish=True)
    attempts, outcomes = [], [False, False, True]
    watcher.on_new = lambda p: (attempts.append(p), outcomes[len(attempts) - 1])[1]
    for _ in range(2):
        assert watcher.poll_once() is None  # a failed rollout is retried
    assert watcher.poll_once() == os.path.abspath(newer)
    assert attempts == [os.path.abspath(newer)] * 3
    assert watcher.poll_once() is None  # latched only after the success


def test_watcher_thread_and_corrupt_manifest_drill(tmp_path, armed):
    """A publish with ``deploy_corrupt_manifest`` armed is never acted on (nor
    published again by hand); the watcher's own thread then takes the next
    good publish."""
    save_dir = str(tmp_path)
    seen, done = [], threading.Event()

    def on_new(path):
        seen.append(path)
        done.set()

    first = ckpt.save_checkpoint(save_dir, 4, _state(), {"update_step": 4})
    watcher = deploy.CheckpointWatcher(save_dir, on_new, interval_s=0.05, current=first)
    assert deploy.main(["publish", first]) == 0
    assert watcher.poll_once() is None  # the serving checkpoint: nothing to do
    armed.configure("deploy_corrupt_manifest")
    second = ckpt.save_checkpoint(save_dir, 8, _state(1), {"update_step": 8})
    assert deploy.main(["publish", second]) == 0  # verified, then the drill corrupts it
    assert armed.fire_count("deploy_corrupt_manifest") == 1
    assert not deploy.verify_checkpoint(second)[0]
    assert watcher.poll_once() is None and seen == []
    assert deploy.main(["publish", second]) == 1  # a corrupt dir is refused by hand
    third = ckpt.save_checkpoint(save_dir, 12, _state(2), {"update_step": 12})
    assert deploy.main(["publish", third]) == 0
    watcher.start()
    try:
        assert done.wait(60.0)
    finally:
        watcher.stop()
    assert seen == [os.path.abspath(third)]


def test_restore_serving_params_refuses_a_corrupt_checkpoint(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 16, _state(), {"update_step": 16})
    bad = _corrupt_params(path)
    with pytest.raises(ValueError, match="refusing to serve") as e:
        ckpt.restore_serving_params(path)
    assert os.path.basename(bad) in str(e.value)


# -- the engine's hot swap --------------------------------------------------------------------


def test_reload_params_on_the_same_weights_is_token_identical(engine):
    prompt = [1, 2, 3, 4]
    before = greedy(engine, prompt)
    live = engine.model.state_dict()
    storage = {k: v.data_ptr() for k, v in live.items()}
    for _ in range(3):
        engine.reload_params(host_tree(engine))
    assert greedy(engine, prompt) == before
    # copied in place: every live tensor kept its storage
    assert {k: v.data_ptr() for k, v in engine.model.state_dict().items()} == storage


def test_reload_params_changes_output_and_swaps_back(engine):
    prompt = [5, 6, 7]
    host = host_tree(engine)
    before = greedy(engine, prompt)
    engine.reload_params(perturb(host, 7))
    assert greedy(engine, prompt) != before
    engine.reload_params({k: v.double() for k, v in host.items()})  # cast on the host
    assert greedy(engine, prompt) == before


def test_reload_params_refuses_bad_state_dicts_untouched(engine):
    host = host_tree(engine)
    first = next(iter(host))
    bad_shape = dict(host, **{first: torch.zeros(3, 3)})
    missing = {k: v for k, v in host.items() if k != first}
    extra = dict(host, not_a_real_leaf=torch.zeros(3))
    # the offending tensor sorts last, so a partial write would show
    late = dict(perturb(host, 3), **{list(host)[-1]: torch.zeros(2)})
    for bad, match in ((bad_shape, "shape mismatch"), (missing, "missing leaf"),
                       (extra, "does not exist in the live tree"), (late, "shape mismatch")):
        with pytest.raises(ValueError, match=match):
            engine.reload_params(bad)
        for k, v in engine.model.state_dict().items():
            assert torch.equal(v, host[k]), k


# -- the server's reload fence -------------------------------------------------------------


def fleet_server(engine, trees, *, version=1, checkpoint="/ckpt/model_1", max_batch=2, **kw):
    """A served scheduler whose ``/admin/reload`` maps fake checkpoint paths
    to prepared state dicts: the transport and the fence under test, no
    disk."""

    def reload_prepare(path):
        tree = trees.get(os.path.abspath(path))
        if tree is None:
            raise ValueError(f"refusing to serve corrupt checkpoint {path}")
        return lambda: engine.reload_params(tree)

    sched = PagedContinuousBatchingScheduler(engine, max_batch=max_batch, seed=0)
    return Served(sched, reload_prepare=reload_prepare, weights_version=version,
                  weights_checkpoint=checkpoint, max_queue=32, **kw)


def pound(port, prompt, n, results):
    def run():
        for _ in range(n):
            results.append(generate(port, {"prompt": prompt, "max_new_tokens": 6})[1]["finish_reason"])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_server_reloads_between_decode_rounds(engine, armed):
    host = host_tree(engine)
    trees = {"/ckpt/model_1": host, "/ckpt/model_2": host}
    with fleet_server(engine, trees) as server:
        port = server.port
        h = health(port)[1]
        assert (h["weights_version"], h["weights_checkpoint"]) == (1, "/ckpt/model_1")
        results = []
        threads = [pound(port, [1, 2, 3], 4, results) for _ in range(2)]
        status, _, body = http(port, "POST", "/admin/reload", {"checkpoint": "/ckpt/model_2"})
        for t in threads:
            t.join(60.0)
        assert status == 200, body
        reply = json.loads(body)
        assert reply["ok"] is True and reply["weights_version"] == 2
        assert len(results) == 8 and all(r == "length" for r in results)  # nothing dropped
        assert health(port)[1]["weights_version"] == 2
        _, _, headers = generate(port, {"prompt": [1], "max_new_tokens": 2})
        assert headers["x-relora-weights"] == "2"
        # a refused checkpoint: 422 before any device write; the version stays
        status, _, body = http(port, "POST", "/admin/reload", {"checkpoint": "/ckpt/nope"})
        assert status == 422 and json.loads(body)["weights_version"] == 2
        assert http(port, "POST", "/admin/reload", {"checkpoint": ""})[0] == 400
        assert http(port, "GET", "/admin/reload")[0] == 405
        assert health(port)[1]["weights_version"] == 2
        text = http(port, "GET", "/metrics")[2].decode()
        assert "relora_serve_weights_version 2" in text
        assert "relora_serve_weights_reloads_total 1" in text


def test_reload_drops_the_old_weights_prefix_pages(engine, armed):
    """A prompt whose full pages sit in the prefix cache from before a swap
    to other weights decodes as on a fresh scheduler of the new weights:
    the swap drops the cached pages (K/V of the old weights)."""
    host = host_tree(engine)
    trees = {"/ckpt/model_1": host, "/ckpt/model_2": perturb(host, 5)}
    prompt = list(range(1, 20))  # two full pages of 8 register
    try:
        with fleet_server(engine, trees) as server:
            port = server.port
            generate(port, {"prompt": prompt, "max_new_tokens": 4})
            assert server.scheduler.prefix_cache.stats()["entries"] > 0
            assert http(port, "POST", "/admin/reload", {"checkpoint": "/ckpt/model_2"})[0] == 200
            assert server.scheduler.prefix_cache.stats()["entries"] == 0
            got = generate(port, {"prompt": prompt, "max_new_tokens": 6})[0]
        fresh = PagedContinuousBatchingScheduler(engine, max_batch=2, seed=0).run(
            [Request(uid=0, prompt=prompt, max_new_tokens=6)])[0].tokens
        assert got == fresh
    finally:
        engine.reload_params(host)


def test_injected_reload_failure_fails_closed(engine, armed):
    host = host_tree(engine)
    trees = {"/ckpt/model_1": host, "/ckpt/model_2": host}
    armed.configure("deploy_reload", exc=RuntimeError)
    with fleet_server(engine, trees) as server:
        port = server.port
        status, _, body = http(port, "POST", "/admin/reload", {"checkpoint": "/ckpt/model_2"})
        reply = json.loads(body)
        assert status == 500 and reply["ok"] is False and "injected fault" in reply["error"]
        h = health(port)[1]
        assert h["status"] == "ok" and h["weights_version"] == 1
        assert generate(port, {"prompt": [1, 2], "max_new_tokens": 4})[1]["finish_reason"] == "length"
        status, _, body = http(port, "POST", "/admin/reload", {"checkpoint": "/ckpt/model_2"})
        assert status == 200 and json.loads(body)["weights_version"] == 2  # the retry lands


def test_reload_over_the_contiguous_engine(armed):
    """The hot swap needs no page pool: a contiguous engine's server swaps
    too, and then decodes as a fresh scheduler on the new weights."""
    from relora_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    contiguous = InferenceEngine(ModelConfig(**TINY), params_from_jax(jax_params()),
                                 device="cpu", cache_size=CACHE)
    other = perturb(host_tree(contiguous), 9)
    sched = ContinuousBatchingScheduler(contiguous, max_batch=2, seed=0)
    with Served(sched, reload_prepare=lambda path: lambda: contiguous.reload_params(other),
                weights_checkpoint="/ckpt/model_1", weights_version=1) as server:
        status, _, body = http(server.port, "POST", "/admin/reload", {"checkpoint": "/ckpt/model_4"})
        assert status == 200 and json.loads(body)["weights_version"] == 4
        got = generate(server.port, {"prompt": [4, 5, 6], "max_new_tokens": 5})[0]
    want = ContinuousBatchingScheduler(contiguous, max_batch=2, seed=0).run(
        [Request(uid=0, prompt=[4, 5, 6], max_new_tokens=5)])[0].tokens
    assert got == want


def test_reload_is_refused_without_a_reload_path(engine, armed):
    sched = PagedContinuousBatchingScheduler(engine, max_batch=2, seed=0)
    with Served(sched) as server:
        assert http(server.port, "POST", "/admin/reload", {"checkpoint": "/x"})[0] == 501


# -- the rolling updater -----------------------------------------------------------------------


def updater(ports, events, **kw):
    return deploy.RollingUpdater(
        lambda: {i: ("127.0.0.1", p) for i, p in enumerate(ports)},
        canary_prompts=[[1, 2, 3], [7, 8]],
        canary_max_new_tokens=4,
        emit=lambda event, idx, detail: events.append((event, idx, detail)),
        probe_timeout_s=30.0,
        verify=lambda path: (True, "ok"),  # fake paths: the transport under test
        **kw,
    )


def test_updater_refuses_a_partial_fleet():
    events = []
    up = deploy.RollingUpdater(
        lambda: {0: ("127.0.0.1", 1), 1: ("127.0.0.1", None)}, expect_replicas=2,
        emit=lambda event, idx, detail: events.append((event, idx, detail)),
        verify=lambda path: (True, "ok"),
    )
    assert up.run("/ckpt/model_5") is False
    assert [e[0] for e in events] == ["deploy_reject"] and "1/2" in str(events[0][2])
    events.clear()
    refused = deploy.RollingUpdater(lambda: {}, emit=lambda e, i, d: events.append(e),
                                    verify=lambda path: (False, "checksum mismatch"))
    assert refused.run("/ckpt/model_6") is False and events == ["deploy_reject"]


def test_canary_failure_rolls_the_whole_fleet_back(engine, engine_b, armed):
    host_a, host_b = host_tree(engine), host_tree(engine_b)
    trees_a = {"/ckpt/model_1": host_a, "/ckpt/model_2": perturb(host_a, 1)}
    # replica b's model_2 is other weights: the canary must catch it
    trees_b = {"/ckpt/model_1": host_b, "/ckpt/model_2": perturb(host_b, 2)}
    try:
        with fleet_server(engine, trees_a) as a, fleet_server(engine_b, trees_b) as b:
            ports = [a.port, b.port]
            events, inflight = [], []
            threads = [pound(p, [9, 9, 9], 3, inflight) for p in ports]
            assert updater(ports, events).run("/ckpt/model_2") is False
            for t in threads:
                t.join(60.0)
            names = [e[0] for e in events]
            assert "deploy_canary_fail" in names and "deploy_rollback" in names
            for port in ports:
                h = health(port)[1]
                assert (h["status"], h["weights_version"], h["weights_checkpoint"]) == (
                    "ok", 1, "/ckpt/model_1")
            assert len(inflight) == 6 and all(r == "length" for r in inflight)
    finally:
        engine.reload_params(host_a)
        engine_b.reload_params(host_b)


def test_crash_mid_update_converges_on_rerun(engine, engine_b, armed):
    host_a, host_b = host_tree(engine), host_tree(engine_b)
    trees_a = {"/ckpt/model_1": host_a, "/ckpt/model_3": perturb(host_a, 1)}
    trees_b = {"/ckpt/model_1": host_b, "/ckpt/model_3": perturb(host_b, 1)}
    try:
        with fleet_server(engine, trees_a) as a, fleet_server(engine_b, trees_b) as b:
            ports = [a.port, b.port]
            events = []
            up = updater(ports, events)
            armed.configure("deploy_crash_mid_update", exc=RuntimeError)
            with pytest.raises(RuntimeError, match="deploy_crash_mid_update"):
                up.run("/ckpt/model_3")
            assert sorted(health(p)[1]["weights_version"] for p in ports) == [1, 3]
            armed.reset()
            assert up.run("/ckpt/model_3") is True
            assert [e[0] for e in events].count("deploy_complete") == 1
            for port in ports:
                h = health(port)[1]
                assert (h["status"], h["weights_version"], h["weights_checkpoint"]) == (
                    "ok", 3, "/ckpt/model_3")
            outs = [generate(p, {"prompt": [3, 1, 4], "max_new_tokens": 5})[0] for p in ports]
            assert outs[0] == outs[1]
            assert up.run("/ckpt/model_3") is True  # the fleet on it already: nothing to walk
    finally:
        engine.reload_params(host_a)
        engine_b.reload_params(host_b)


# -- serve_cli ---------------------------------------------------------------------------------


def test_cli_watch_checkpoints_swaps_a_published_checkpoint(tmp_path):
    """``serve_cli --checkpoint model_1 --watch-checkpoints SAVE_DIR`` in a
    process of its own: a ``deploy publish`` of ``model_2`` moves it to
    weights_version 2 (``X-Relora-Weights`` too), a corrupt publish of
    ``model_3`` never does, and SIGTERM drains it (exit 0) with the swap and
    the kernel launches in its metrics.jsonl."""
    import signal
    import subprocess
    import sys

    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.serve.engine import build_decode_model
    from relora_tpu_torch.utils import faults
    from tests.test_torch_adapters import write_config
    from tests.test_torch_server import REPO, wait_for

    save_dir = tmp_path / "ckpts"
    model = build_decode_model(ModelConfig(**TINY), device="cpu")
    paths = {}
    for step in (1, 2, 3):
        init_params(model, torch.Generator().manual_seed(step))
        paths[step] = ckpt.save_checkpoint(str(save_dir), step, model.state_dict(),
                                           {"update_step": step})
    port_file, run_dir = tmp_path / "port", tmp_path / "run"
    argv = ["--model_config", write_config(tmp_path), "--checkpoint", paths[1], "--paged",
            "--device", "cpu", "--cache-size", str(CACHE), "--page-size", str(PAGE),
            "--chunk-size", str(CHUNK), "--max-batch", "2", "--max-new-tokens", "3", "--port", "0",
            "--port-file", str(port_file), "--run-dir", str(run_dir),
            "--watch-checkpoints", str(save_dir), "--watch-interval-s", "0.1"]
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("RELORA_TPU_FAULTS", None)
    log = open(tmp_path / "stderr.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "relora_tpu_torch.serve_cli", *argv], cwd=REPO,
                            env=env, stdout=subprocess.DEVNULL, stderr=log)
    try:
        wait_for(lambda: port_file.exists() and port_file.read_text().strip(), "the port file")
        port = int(port_file.read_text())
        wait_for(lambda: health(port)[1]["status"] == "ok", "healthz ok")
        assert health(port)[1]["weights_version"] == 1
        assert deploy.main(["publish", paths[2]]) == 0
        wait_for(lambda: health(port)[1]["weights_version"] == 2, "the watcher's swap")
        h = health(port)[1]
        assert h["weights_checkpoint"] == os.path.abspath(paths[2])
        assert generate(port, {"prompt": [1, 2, 3]})[2]["x-relora-weights"] == "2"
        faults.configure("deploy_corrupt_manifest")
        try:
            assert deploy.main(["publish", paths[3]]) == 0
        finally:
            faults.reset()
        wait_for(lambda: f"rejecting {paths[3]}" in (tmp_path / "stderr.log").read_text(),
                 "the watcher's reject")
        assert health(port)[1]["weights_version"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, (tmp_path / "stderr.log").read_text()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        log.close()
    with open(run_dir / "metrics.jsonl") as f:
        events = {r["_event"]: r for r in map(json.loads, f) if "_event" in r}
    assert events["serve_reload"]["weights_version"] == 2
    assert set(events["kernel_launches"]) >= {"paged_decode_attention", "packed_paged_attention",
                                              "warmup/paged_decode_attention"}


def test_cli_wires_roles_and_peers(tmp_path):
    """``--role`` reaches the paged scheduler, ``--peer-file`` and the reload
    path the server; a prefill server hands its runs to the migration sink."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.serve.server import GenerateServer
    from tests.test_torch_adapters import write_config

    argv = ["--model_config", write_config(tmp_path), "--random-init", "--paged", "--device", "cpu",
            "--cache-size", str(CACHE), "--max-batch", "2", "--port", "0", "--role", "prefill",
            "--peer-file", str(tmp_path / "peers.json"), "--migrate-timeout-s", "7"]
    sched, kw = serve_cli.build_server(serve_cli.parse_args(argv))
    assert sched.role == "prefill" and kw["peer_file"] == str(tmp_path / "peers.json")
    assert kw["migrate_timeout_s"] == 7.0 and kw["weights_version"] == 0
    assert callable(kw["reload_prepare"])
    server = GenerateServer(sched, **kw)
    assert sched.migration_sink == server._migration_sink
    with pytest.raises(ValueError, match="no params.pt"):
        kw["reload_prepare"](str(tmp_path / "model_9"))
    with pytest.raises(SystemExit, match="--spec model needs --role mixed"):
        serve_cli.main(argv[:-6] + ["--role", "decode", "--spec", "model", "--draft-checkpoint", "d"])
