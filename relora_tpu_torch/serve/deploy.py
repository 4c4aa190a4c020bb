"""Continuous deployment: the ``latest`` pointer, the checkpoint watcher, and
the rolling fleet update with its canary gate.

The port's own copy of ``relora_tpu/serve/deploy.py``, the last mile of the
train, merge, serve loop:

- :func:`publish_latest` / :func:`read_latest` — an atomically replaced
  ``latest`` pointer file beside the checkpoints.  The trainer publishes it
  right after a checkpoint's manifest, the port's commit marker, is written
  (``train/checkpoint.save_checkpoint(publish=True)``), so the pointer only
  ever names committed directories.
- :class:`CheckpointWatcher` — polls the pointer and hands *verified*
  checkpoint directories to a callback; the size and crc32 check against
  ``manifest.json`` (``train/checkpoint.verify_checkpoint``) runs before the
  callback sees a path.
- :class:`RollingUpdater` — one replica at a time over ``POST
  /admin/reload``: reload, probe ``/healthz`` until the new
  ``weights_version`` reports ok, replay greedy canary prompts that must be
  token-identical, then the next replica.  Any failure rolls the whole
  fleet back to the previous version.

Drill sites (``utils/faults.py``): ``deploy_corrupt_manifest`` (a publish
flips a byte of the checkpoint's manifest), ``deploy_reload`` (the server's
apply boundary raises), ``deploy_crash_mid_update`` (the updater dies
between replicas).

The port reads only its own checkpoint format (``params.pt`` beside JSON
sidecars and the manifest).  Nothing here imports torch at module load: the
verifier is imported when first called, so the fleet's front-end processes
can drive the updater.

    python -m relora_tpu_torch.serve.deploy publish SAVE_DIR/model_N
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from relora_tpu_torch.utils import faults
from relora_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LATEST_FILE = "latest"
#: the port's checkpoint commit marker (``train/checkpoint.MANIFEST_FILE``)
MANIFEST_FILE = "manifest.json"

#: the default canary prompts: tiny token-id prompts every model config can
#: decode; deployments pass their own
DEFAULT_CANARY_PROMPTS: Tuple[Tuple[int, ...], ...] = ((1, 2, 3), (4, 5, 6, 7), (2,))
CANARY_FILE = "canary.json"


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """``train/checkpoint.verify_checkpoint``: ``(ok, reason)`` of ``path``
    against its manifest (each file's size and crc32)."""
    from relora_tpu_torch.train.checkpoint import verify_checkpoint as verify

    return verify(path)


def checkpoint_step(path: str) -> Optional[int]:
    """The step of a ``model_{step}`` directory name, or None; it doubles as
    that checkpoint's fleet-wide ``weights_version``."""
    base = os.path.basename(os.path.normpath(path))
    prefix, _, step = base.rpartition("_")
    if prefix.startswith("model") and step.isdigit():
        return int(step)
    return None


def publish_latest(save_dir: str, path: str) -> str:
    """Point ``save_dir/latest`` at checkpoint ``path``, atomically (a temp
    file and ``os.replace``: a reader sees the old pointer or the new one,
    never a torn file).  Call it only for committed directories.  Returns
    the pointer's path."""
    pointer = os.path.join(save_dir, LATEST_FILE)
    record = {
        "path": os.path.basename(os.path.normpath(path)),
        "step": checkpoint_step(path),
        "published_unix": time.time(),
    }
    tmp = pointer + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, pointer)
    logger.info(f"published latest -> {record['path']}")
    if faults.should("deploy_corrupt_manifest"):
        # drill: the published checkpoint's manifest gets a flipped byte, so
        # watchers must reject the directory and the fleet keep its version
        manifest = os.path.join(path, MANIFEST_FILE)
        try:
            with open(manifest, "r+b") as f:
                byte = f.read(1)
                f.seek(0)
                f.write(bytes([byte[0] ^ 0xFF]) if byte else b"X")
            logger.warning(f"fault deploy_corrupt_manifest: corrupted {manifest}")
        except OSError as e:
            logger.warning(f"fault deploy_corrupt_manifest could not corrupt: {e}")
    return pointer


def read_latest(save_dir: str) -> Optional[str]:
    """The absolute directory the ``latest`` pointer names, or None when
    there is no pointer or it is unreadable (a torn pointer reads as absent)
    or names a path outside ``save_dir``."""
    pointer = os.path.join(save_dir, LATEST_FILE)
    try:
        with open(pointer) as f:
            record = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    name = record.get("path") if isinstance(record, dict) else None
    if not isinstance(name, str) or not name or os.sep in name:
        return None
    return os.path.abspath(os.path.join(save_dir, name))


class CheckpointWatcher:
    """Polls ``save_dir/latest`` and hands each new, *verified* checkpoint
    directory to ``on_new(path)``.

    ``on_new`` never sees a directory that failed the manifest check.  A
    rejected directory is remembered by its manifest's mtime and size, so an
    unchanged bad directory is not verified again every poll, while a
    re-publish or a repaired manifest is.  ``on_new`` returning False (a
    rollout that failed) leaves the watcher unlatched: the next poll tries
    again.  ``on_reject(path, reason)`` is optional telemetry.
    """

    def __init__(
        self,
        save_dir: str,
        on_new: Callable[[str], Any],
        *,
        interval_s: float = 2.0,
        verify: Callable[[str], Tuple[bool, str]] = verify_checkpoint,
        on_reject: Optional[Callable[[str, str], None]] = None,
        current: Optional[str] = None,
    ):
        self.save_dir = save_dir
        self.on_new = on_new
        self.on_reject = on_reject
        self.interval_s = interval_s
        self.verify = verify
        # the directory serving now: the watcher fires only for others
        self._current = os.path.abspath(current) if current else None
        self._rejected: Optional[Tuple[str, Any]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _signature(self, path: str) -> Tuple[str, Any]:
        try:
            st = os.stat(os.path.join(path, MANIFEST_FILE))
            return path, (st.st_mtime_ns, st.st_size)
        except OSError:
            return path, None

    def poll_once(self) -> Optional[str]:
        """One poll: the newly accepted checkpoint's path, or None."""
        target = read_latest(self.save_dir)
        if target is None or target == self._current:
            return None
        sig = self._signature(target)
        if sig == self._rejected:
            return None  # the same bad directory, unchanged since its reject
        ok, reason = self.verify(target)
        if not ok:
            self._rejected = sig
            logger.warning(f"checkpoint watcher: rejecting {target}: {reason}")
            if self.on_reject is not None:
                self.on_reject(target, reason)
            return None
        self._rejected = None
        logger.info(f"checkpoint watcher: verified new checkpoint {target}")
        if self.on_new(target) is False:
            return None  # the rollout failed: retried at the next poll
        self._current = target
        return target

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception as e:
                # the loop outlives a failing callback: the next publish
                # still gets its chance
                logger.error(f"checkpoint watcher poll failed: {e!r}")

    def start(self) -> "CheckpointWatcher":
        self._thread = threading.Thread(target=self._run, name="ckpt-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# -- the rolling fleet update -------------------------------------------------------


def _http_json(
    host: str, port: int, method: str, path: str, body: Optional[dict] = None,
    timeout: float = 120.0,
) -> Tuple[int, dict]:
    """One request to a replica: ``(status, parsed JSON body)`` (``{}`` when
    the body is not JSON).  The server closes every connection."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"} if payload else {})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return resp.status, {}
    finally:
        conn.close()


class CanaryMismatch(Exception):
    """A replica's greedy canary output diverged from the baseline."""


class _ReplicaUpdateFailed(Exception):
    """A replica's reload or its health probe after it failed."""


class RollingUpdater:
    """Rolling weight update with a canary gate and a fleet-wide rollback.

    ``endpoints`` is a zero-argument callable returning ``{idx: (host,
    port)}`` (a port of None: a replica not up yet); ``emit(event, idx,
    detail)`` receives the ``deploy_*`` events.  One replica at a time: a
    reload through ``/admin/reload`` (the server fences the swap between
    decode rounds, so no in-flight request is dropped), a ``/healthz`` probe
    until the replica reports the new ``weights_version`` with status ok,
    then the canary prompts, whose greedy output must equal the baseline of
    the new version: ``<checkpoint>/canary.json`` when present, else the
    first updated replica's output.  Any reload, probe or canary failure
    reloads every replica back to the previous version, and :meth:`run`
    returns False.
    """

    def __init__(
        self,
        endpoints: Callable[[], Dict[int, Tuple[str, Optional[int]]]],
        *,
        canary_prompts: Optional[List[List[int]]] = None,
        canary_max_new_tokens: int = 8,
        expect_replicas: Optional[int] = None,
        emit: Optional[Callable[[str, Optional[int], dict], None]] = None,
        probe_timeout_s: float = 120.0,
        probe_interval_s: float = 0.2,
        request_timeout_s: float = 120.0,
        verify: Callable[[str], Tuple[bool, str]] = verify_checkpoint,
    ):
        self.endpoints = endpoints
        self.canary_prompts = [list(p) for p in (canary_prompts or DEFAULT_CANARY_PROMPTS)]
        self.canary_max_new_tokens = canary_max_new_tokens
        self.expect_replicas = expect_replicas
        self._emit_cb = emit
        self.probe_timeout_s = probe_timeout_s
        self.probe_interval_s = probe_interval_s
        self.request_timeout_s = request_timeout_s
        self.verify = verify

    def _emit(self, event: str, idx: Optional[int], **detail: Any) -> None:
        logger.info(f"{event} replica={idx} {detail}")
        if self._emit_cb is not None:
            try:
                self._emit_cb(event, idx, detail)
            except Exception as e:
                logger.warning(f"deploy event sink failed: {e!r}")

    def _live_endpoints(self) -> Dict[int, Tuple[str, int]]:
        return {
            idx: (host, port)
            for idx, (host, port) in sorted(self.endpoints().items())
            if port is not None
        }

    def _healthz(self, host: str, port: int) -> dict:
        try:
            return _http_json(host, port, "GET", "/healthz", timeout=10.0)[1]
        except OSError:
            return {}

    def _probe_until(self, host: str, port: int, version: Optional[int]) -> bool:
        """Wait for the replica to report status ok on ``version``."""
        deadline = time.monotonic() + self.probe_timeout_s
        while time.monotonic() < deadline:
            h = self._healthz(host, port)
            if h.get("status") == "ok" and h.get("weights_version") == version:
                return True
            time.sleep(self.probe_interval_s)
        return False

    def _generate(self, host: str, port: int, prompt: List[int]) -> List[int]:
        status, body = _http_json(
            host, port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new_tokens": self.canary_max_new_tokens,
             "temperature": 0.0, "stream": False},
            timeout=self.request_timeout_s,
        )
        if status != 200 or body.get("finish_reason") not in ("eos", "length"):
            raise CanaryMismatch(
                f"canary request failed on replica port {port}: "
                f"HTTP {status} {body.get('finish_reason') or body.get('error')}"
            )
        return list(body.get("tokens") or [])

    def _reload(self, host: str, port: int, path: str) -> Tuple[bool, dict]:
        try:
            status, body = _http_json(host, port, "POST", "/admin/reload", {"checkpoint": path},
                                      timeout=self.request_timeout_s)
        except OSError as e:
            return False, {"error": f"{e!r}"}
        return status == 200 and bool(body.get("ok")), body

    def _load_baseline(self, path: str) -> Optional[List[List[int]]]:
        """The checkpoint's recorded canary (prompts, tokens), if any."""
        try:
            with open(os.path.join(path, CANARY_FILE)) as f:
                record = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        prompts, tokens = record.get("prompts"), record.get("tokens")
        if not isinstance(prompts, list) or not isinstance(tokens, list):
            return None
        self.canary_prompts = [list(p) for p in prompts]
        if isinstance(record.get("max_new_tokens"), int):
            self.canary_max_new_tokens = record["max_new_tokens"]
        return [list(t) for t in tokens]

    def _run_canary(
        self, idx: int, host: str, port: int, baseline: Optional[List[List[int]]]
    ) -> List[List[int]]:
        """Replay the canary prompts; raises CanaryMismatch on a divergence.
        Returns the outputs (the baseline, for the first replica)."""
        outs = [self._generate(host, port, p) for p in self.canary_prompts]
        if baseline is not None:
            for i, (got, want) in enumerate(zip(outs, baseline)):
                if got != want:
                    raise CanaryMismatch(
                        f"replica {idx} canary prompt {i} diverged: got {got}, baseline {want}"
                    )
        return outs

    def run(self, new_path: str) -> bool:
        """Roll the fleet onto ``new_path``: True on success, False after a
        rollback (or when the checkpoint or the fleet is refused)."""
        new_path = os.path.abspath(new_path)
        ok, reason = self.verify(new_path)
        if not ok:
            self._emit("deploy_reject", None, checkpoint=new_path, reason=reason)
            return False
        version = checkpoint_step(new_path)
        eps = self._live_endpoints()
        if not eps or (self.expect_replicas and len(eps) < self.expect_replicas):
            # walking a partly booted fleet would latch mixed versions
            self._emit(
                "deploy_reject", None, checkpoint=new_path,
                reason=f"{len(eps)}/{self.expect_replicas or '?'} replicas live",
            )
            return False
        # a crashed earlier update leaves mixed versions: replicas already on
        # the target are walked again (a reload is idempotent), and the
        # rollback target comes from a replica not on it
        states = {idx: self._healthz(host, port) for idx, (host, port) in eps.items()}
        on_target = [
            idx for idx, h in states.items()
            if h.get("weights_checkpoint") and os.path.abspath(h["weights_checkpoint"]) == new_path
        ]
        if len(on_target) == len(eps):
            return True  # the whole fleet is on this checkpoint already
        prev_version, prev_path = None, None
        for h in states.values():
            ck = h.get("weights_checkpoint")
            if ck and os.path.abspath(ck) != new_path:
                prev_version, prev_path = h.get("weights_version"), ck
                break
        if version is None:
            version = (prev_version or 0) + 1
        self._emit("deploy_begin", None, checkpoint=new_path, version=version,
                   prev_version=prev_version, replicas=len(eps))
        baseline = self._load_baseline(new_path)
        recorded = baseline is not None
        updated: List[int] = []
        try:
            for idx, (host, port) in eps.items():
                ok, body = self._reload(host, port, new_path)
                if not ok:
                    self._emit("deploy_reload_failed", idx, checkpoint=new_path,
                               error=body.get("error", f"{body}"))
                    raise _ReplicaUpdateFailed("reload failed")
                if not self._probe_until(host, port, version):
                    self._emit("deploy_probe_failed", idx, checkpoint=new_path, version=version)
                    raise _ReplicaUpdateFailed("health probe failed")
                outs = self._run_canary(idx, host, port, baseline)
                if baseline is None:
                    baseline = outs
                    self._emit("deploy_canary_recorded", idx, version=version, prompts=len(outs))
                updated.append(idx)
                self._emit("deploy_replica_updated", idx, version=version)
                # drill: die between replicas, leaving a mixed-version fleet
                faults.crash_point("deploy_crash_mid_update")
        except CanaryMismatch as e:
            self._emit("deploy_canary_fail", None, error=f"{e}", updated=len(updated))
            self._rollback(eps, prev_version, prev_path, from_version=version)
            return False
        except _ReplicaUpdateFailed as e:
            self._emit("deploy_fail", None, error=f"{e}", updated=len(updated))
            self._rollback(eps, prev_version, prev_path, from_version=version)
            return False
        self._emit("deploy_complete", None, version=version, checkpoint=new_path,
                   canary_recorded=not recorded, replicas=len(updated))
        return True

    def _rollback(
        self,
        eps: Dict[int, Tuple[str, int]],
        prev_version: Optional[int],
        prev_path: Optional[str],
        from_version: Optional[int] = None,
    ) -> None:
        """Reload every replica not healthy on the previous version back onto
        it, so the fleet converges on one version."""
        if not prev_path:
            self._emit("deploy_rollback_impossible", None, reason="no previous checkpoint known")
            return
        self._emit("deploy_rollback", None, to_version=prev_version, to_checkpoint=prev_path,
                   from_version=from_version)
        for idx, (host, port) in eps.items():
            h = self._healthz(host, port)
            if h.get("status") == "ok" and h.get("weights_version") == prev_version:
                continue  # never updated, or back already
            ok, body = self._reload(host, port, prev_path)
            if not ok:
                self._emit("deploy_rollback_replica_failed", idx, error=body.get("error", f"{body}"))
                continue
            if self._probe_until(host, port, prev_version):
                self._emit("deploy_replica_rolled_back", idx, version=prev_version)
            else:
                self._emit("deploy_rollback_replica_failed", idx, error="probe timeout")


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m relora_tpu_torch.serve.deploy publish DIR``: verify a
    checkpoint directory and publish its save directory's ``latest``
    pointer at it (the trainer's automatic publish, by hand).  Faults named
    by ``RELORA_TPU_FAULTS`` are armed first (``deploy_corrupt_manifest``)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    pub = sub.add_parser("publish", help="verify, then publish latest -> DIR")
    pub.add_argument("checkpoint", help="model_{step} checkpoint dir")
    pub.add_argument("--force", action="store_true",
                     help="publish even if verification fails (corruption drills only)")
    args = ap.parse_args(argv)
    faults.configure_from_env()
    path = os.path.abspath(args.checkpoint)
    ok, reason = verify_checkpoint(path)
    if not ok and not args.force:
        print(f"refusing to publish {path}: {reason}")
        return 1
    pointer = publish_latest(os.path.dirname(path), path)
    print(f"published {pointer} -> {os.path.basename(path)} ({reason})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
