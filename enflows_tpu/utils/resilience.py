"""Failure detection and elastic recovery (SURVEY.md §5: ABSENT upstream).

Preemption-tolerant training: a generic checkpointed step loop that resumes
from the latest checkpoint after a crash (resume equivalence is a tested
invariant — tests/test_resilience.py kills a run mid-way and asserts the
resumed result matches the uninterrupted one), plus a psum heartbeat
barrier that surfaces dead hosts as a timeout instead of a silent hang.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .checkpoint import save_checkpoint, restore_checkpoint, latest_step


class HeartbeatTimeout(RuntimeError):
    """The cross-host liveness probe did not complete within its deadline
    — a host/device is dead or a collective is hung. The raiser has
    already persisted the latest checkpoint; restart the job and
    ``run_checkpointed`` resumes from it."""


def run_checkpointed(step_fn: Callable, state: Any, num_steps: int, *,
                     ckpt_dir: Optional[str] = None,
                     checkpoint_every: int = 100,
                     resume: bool = True,
                     on_step: Optional[Callable] = None,
                     heartbeat_every: Optional[int] = None,
                     heartbeat_timeout_s: float = 60.0,
                     _heartbeat_fn: Optional[Callable] = None):
    """Run ``state = step_fn(state, i)`` for i in [0, num_steps), saving
    every ``checkpoint_every`` steps and resuming from the latest saved
    step if ``resume`` and a checkpoint exists.

    step_fn must be deterministic given (state, i) — fold i into RNG keys —
    so a resumed run is bit-identical to an uninterrupted one.

    ``heartbeat_every`` (optional): every N steps, run the :func:`heartbeat`
    psum liveness probe with deadline ``heartbeat_timeout_s``. On failure
    the loop saves a checkpoint of the last known-good state (the one the
    probe preceded) and raises :class:`HeartbeatTimeout` — the detection
    subsystem protecting the loop that exists to survive failures, per
    SURVEY.md §5's failure-detection row. ``_heartbeat_fn`` injects a probe
    for tests (fault injection = a never-completing probe).

    Returns (state, start_step_used).
    """
    hb = _heartbeat_fn if _heartbeat_fn is not None else heartbeat
    start = 0
    if ckpt_dir and resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, state, step=last)
            start = last
    for i in range(start, num_steps):
        state = step_fn(state, i)
        done = i + 1
        if ckpt_dir and (done % checkpoint_every == 0
                         or done == num_steps):
            jax.block_until_ready(state)
            save_checkpoint(ckpt_dir, state, step=done)
        if heartbeat_every and done % heartbeat_every == 0:
            if not hb(heartbeat_timeout_s):
                rescued = False
                if ckpt_dir:
                    # Persist the last completed step so the restarted job
                    # loses at most ``heartbeat_every`` steps of work. The
                    # readiness wait itself can hang forever when the step's
                    # pending cross-host collectives involve the dead host
                    # (the exact condition the probe just detected), so the
                    # rescue runs under its own deadline — HeartbeatTimeout
                    # is raised REGARDLESS once it elapses (ADVICE r3).
                    def _rescue():
                        jax.block_until_ready(state)
                        save_checkpoint(ckpt_dir, state, step=done)
                    rescued = _run_with_deadline(
                        _rescue, heartbeat_timeout_s)
                raise HeartbeatTimeout(
                    f"liveness probe failed/timed out after step {done} "
                    f"(deadline {heartbeat_timeout_s}s); rescue checkpoint "
                    + ("saved" if rescued else
                       "NOT saved (state unready within deadline — resume "
                       "from the last periodic checkpoint)"))
        if on_step is not None:
            on_step(i, state)
    return state, start


def _run_with_deadline(fn: Callable[[], None], timeout_s: float) -> bool:
    """Run ``fn()`` in a daemon thread, waiting at most ``timeout_s``.
    Returns True iff fn completed without raising. A timed-out thread is
    left parked (the hang is inside the runtime and cannot be cancelled);
    the caller's job is to raise and let the scheduler restart the job."""
    result: dict = {}

    def _work():
        try:
            fn()
            result["ok"] = True
        except Exception:
            result["ok"] = False

    th = threading.Thread(target=_work, daemon=True,
                          name="enflows-rescue")
    th.start()
    th.join(timeout_s)
    return (not th.is_alive()) and result.get("ok", False)


_PROBE_CACHE: dict = {}


def _default_probe() -> bool:
    """Dispatch the psum barrier and verify its value. May block
    indefinitely if a host is dead — always called under the watchdog.

    The compiled probe and its sharded input are cached per device set, so
    only the FIRST heartbeat of a process pays jit compilation; steady-state
    probes cost one small collective.
    Probe once at job start with a generous deadline to absorb the compile,
    then use a tight deadline in the loop (``heartbeat_every``)."""
    devs = jax.devices()
    n = len(devs)
    key = tuple(id(d) for d in devs)
    cached = _PROBE_CACHE.get(key)
    if cached is None:
        mesh = Mesh(np.asarray(devs), ("hb",))
        x = jax.device_put(jnp.ones((n,), jnp.float32),
                           NamedSharding(mesh, P("hb")))
        probe = jax.jit(jax.shard_map(
            lambda v: lax.psum(jnp.sum(v), "hb"),
            mesh=mesh, in_specs=P("hb"), out_specs=P()))
        _PROBE_CACHE.clear()        # device set changed: old probe is dead
        _PROBE_CACHE[key] = cached = (probe, x)
    probe, x = cached
    out = probe(x)
    out.block_until_ready()
    return float(out) == float(n)


def heartbeat(timeout_s: float = 60.0, *,
              _probe: Optional[Callable] = None) -> bool:
    """Cross-host liveness probe with a REAL deadline.

    The probe is a psum barrier spanning every device in the system (a
    one-element-per-device array psum'd under ``shard_map`` — an actual
    collective every host must participate in). With a dead host,
    that collective never completes, so the probe runs inside a watchdog
    thread and this function returns ``False`` once ``timeout_s`` elapses
    without completion — it never blocks past the deadline, no matter
    where the hang happens (dispatch, cross-host compile barrier, or the
    collective itself). A wrong psum value (corrupt device) also returns
    ``False``.

    The timed-out watchdog thread is a daemon parked on the dead
    collective; it cannot be cancelled (the hang is inside the runtime),
    which is fine — the caller's job is to checkpoint and exit so the
    scheduler can restart the job (see ``run_checkpointed``).
    """
    probe = _probe if _probe is not None else _default_probe
    result: dict = {}

    def _work():
        try:
            result["ok"] = bool(probe())
        except Exception:
            result["ok"] = False

    th = threading.Thread(target=_work, daemon=True,
                          name="enflows-heartbeat")
    th.start()
    th.join(timeout_s)
    if th.is_alive():       # deadline exceeded: dead host or hung runtime
        return False
    return result.get("ok", False)
