"""Fault injection for the serving and deployment drills.

The port's own copy of the serving and deployment sites of
``relora_tpu/utils/faults.py``; the training sites (``perturb``,
``nan_grad_steps``, ``tick``) come with the slice that needs them.  Every
site is a no-op until a fault is armed:

- ``serve_tick(tokens)`` — called by the server's model thread once per loop
  iteration with the cumulative sampled-token count; drives ``serve_stall``
  (``sleep_s=S,at_token=N``: block the loop so the stall watchdog trips),
  ``serve_decode`` (``exc=...,at_token=N``: raise on the model thread, the
  worker-death path) and ``serve_crash`` (``at_token=N,code=C``:
  ``os._exit``, a kill -9-shaped crash).
- ``should("serve_accept_drop")`` — the server closes the first ``times``
  accepted connections without a byte of response.
- ``maybe_fail(site)`` — raise the armed exception ``times`` times; the
  sites are ``serve_migrate`` (the donor's page-run export: the prefill
  replica fails open to local decode, counted as a migration failure) and
  ``deploy_reload`` (the server's apply boundary: the reload fails closed
  and the old weights keep serving).
- ``should("deploy_corrupt_manifest")`` — a publish of the ``latest``
  pointer flips a byte of the checkpoint's manifest: watchers must reject
  the directory.
- ``crash_point("deploy_crash_mid_update")`` — the rolling updater dies
  between replicas (``code=N``: ``os._exit``; else the armed exception).

Faults are armed with ``configure`` / ``reset`` (tests) or, for CLI drills,
``RELORA_TPU_FAULTS`` read by ``configure_from_env`` (``serve_cli`` calls it
at startup), e.g. ``RELORA_TPU_FAULTS="serve_stall:sleep_s=2,at_token=10"``.
Never arm a fault in a production launch.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from relora_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_FAULTS: dict[str, dict] = {}
_FIRED: dict[str, int] = {}

_EXC_NAMES = {
    "oserror": OSError,
    "ioerror": IOError,
    "timeout": TimeoutError,
    "connectionerror": ConnectionError,
    "runtimeerror": RuntimeError,
}


def configure(site: str, **spec: Any) -> None:
    """Arm a fault at ``site``.  Spec keys (site-dependent): ``times``,
    ``exc`` (exception class), ``at_token``, ``sleep_s``, ``code``."""
    _FAULTS[site] = spec
    _FIRED.setdefault(site, 0)
    logger.warning(f"fault armed: {site} {spec}")


def reset() -> None:
    """Disarm everything."""
    _FAULTS.clear()
    _FIRED.clear()


def active(site: Optional[str] = None) -> bool:
    return bool(_FAULTS) if site is None else site in _FAULTS


def fire_count(site: str) -> int:
    return _FIRED.get(site, 0)


def _take(site: str, spec: dict) -> bool:
    """Count one firing of ``site`` if it has fired fewer than ``times``."""
    times = int(spec.get("times", 1))
    if _FIRED.get(site, 0) >= times:
        return False
    _FIRED[site] = _FIRED.get(site, 0) + 1
    return True


def should(site: str) -> bool:
    """True for the first ``times`` calls at an armed site (a drop/skip
    fault, where raising would take the wrong code path)."""
    spec = _FAULTS.get(site)
    if spec is None or not _take(site, spec):
        return False
    logger.warning(f"fault fired: {site!r} ({_FIRED[site]}/{int(spec.get('times', 1))})")
    return True


def maybe_fail(site: str) -> None:
    """Raise the armed exception at ``site`` for the first ``times`` calls."""
    spec = _FAULTS.get(site)
    if spec is None or not _take(site, spec):
        return
    exc = spec.get("exc", OSError)
    raise exc(f"injected fault at {site!r} ({_FIRED[site]}/{int(spec.get('times', 1))})")


def crash_point(site: str) -> None:
    """A death or an abort in the middle of a procedure: with ``code=N`` the
    process exits through ``os._exit`` (a SIGKILL-shaped drill for a fleet
    of processes), else the armed exception (default RuntimeError) is
    raised, ``times`` times."""
    spec = _FAULTS.get(site)
    if spec is None or not _take(site, spec):
        return
    if "code" in spec:
        code = int(spec["code"])
        logger.warning(f"fault {site!r}: os._exit({code})")
        os._exit(code)
    exc = spec.get("exc", RuntimeError)
    raise exc(f"injected fault at {site!r} ({_FIRED[site]}/{int(spec.get('times', 1))})")


def serve_tick(tokens: int) -> None:
    """The model thread's per-iteration sites; each triggers once ``tokens``
    reaches its ``at_token`` (default 0), at most ``times`` times."""
    spec = _FAULTS.get("serve_stall")
    if spec is not None and tokens >= int(spec.get("at_token", 0)) and _take("serve_stall", spec):
        sleep_s = float(spec.get("sleep_s", 1.0))
        logger.warning(f"fault serve_stall: blocking decode for {sleep_s}s")
        time.sleep(sleep_s)
    spec = _FAULTS.get("serve_decode")
    if spec is not None and tokens >= int(spec.get("at_token", 0)) and _take("serve_decode", spec):
        exc = spec.get("exc", RuntimeError)
        raise exc(f"injected fault at 'serve_decode' (token {tokens})")
    spec = _FAULTS.get("serve_crash")
    if spec is not None and tokens >= int(spec.get("at_token", 0)) and _take("serve_crash", spec):
        code = int(spec.get("code", 13))
        logger.warning(f"fault serve_crash: os._exit({code}) at token {tokens}")
        os._exit(code)


def summary() -> str:
    """One line naming every armed fault, logged at server start so a drill
    is never taken for production."""
    if not _FAULTS:
        return "faults: none armed"
    parts = []
    for site in sorted(_FAULTS):
        kv = ",".join(
            f"{k}={getattr(v, '__name__', v)}" for k, v in sorted(_FAULTS[site].items())
        )
        parts.append(f"{site}:{kv}" if kv else site)
    return "FAULTS ARMED (drill, not production): " + "; ".join(parts)


def configure_from_env(env: Optional[str] = None) -> None:
    """Arm the faults ``RELORA_TPU_FAULTS`` names: ``site:key=value,...``
    parts joined by ``;``; ``exc`` takes the names of ``_EXC_NAMES``."""
    raw = env if env is not None else os.environ.get("RELORA_TPU_FAULTS", "")
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, body = part.partition(":")
        spec: dict[str, Any] = {}
        for kv in filter(None, body.split(",")):
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if k == "exc":
                spec["exc"] = _EXC_NAMES.get(v.lower(), OSError)
            elif k in ("times", "at_token", "code"):
                spec[k] = int(v)
            elif k == "sleep_s":
                spec[k] = float(v)
            else:
                logger.warning(f"unknown fault spec key {k!r} in {part!r}; ignored")
        configure(site.strip(), **spec)
