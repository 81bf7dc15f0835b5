"""Profiler capture: ``torch.profiler`` traces on demand and per generation.

The JAX package's hooks (llama_fastapi_k8s_gpu_tpu/utils/tracing.py) with
``jax.profiler`` replaced by ``torch.profiler``, recording the CPU activity
of every thread and, where a card is present, CUDA activity (kernels,
graph launches and copies, through CUPTI), exported as Chrome traces into
``LFKT_PROFILE_DIR``:

- :func:`capture_profile` — ``GET /debug/profile``: a bounded window of
  everything the process does, clamped to
  [:data:`MIN_CAPTURE_SECONDS`, :data:`MAX_CAPTURE_SECONDS`];
- :func:`maybe_profile` — with the directory set, every generation records
  its own trace; unset, it costs one knob read;
- :func:`prepare_profiler` — with the directory set, the app's startup
  starts and stops one profiler before the pod reports READY, so the
  process pays kineto's and CUPTI's one-time set-up there and not inside
  the first capture's window; unset, it touches no profiler.

The profiler is process-global and a second one inside a running one
raises, so one lock covers both: a capture asked for while another (or a
generation's) runs is refused with :class:`ProfileBusy` (409), and a
generation that finds the profiler taken runs unprofiled.  Anything else
that starts ``torch.profiler`` in the process must not overlap them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

#: /debug/profile capture bounds: a runaway ``seconds=`` must not park the
#: profiler on a serving pod
MAX_CAPTURE_SECONDS = 30.0
MIN_CAPTURE_SECONDS = 0.05

#: one profiler at a time, capture or generation
_CAPTURE_LOCK = threading.Lock()

#: the process's profiler set-up (:func:`prepare_profiler`): how many times
#: it ran (at most once a process) and its seconds
_PREPARED = {"count": 0, "seconds": None}


class ProfileDisabled(RuntimeError):
    """LFKT_PROFILE_DIR is unset — profiling is opt-in, off by default."""


class ProfileBusy(RuntimeError):
    """A capture is already running (the exclusive-capture guard)."""


def profile_dir() -> str | None:
    from .config import knob

    return knob("LFKT_PROFILE_DIR") or None


def _profiler():
    """A profiler of CPU and (on the card) CUDA activity that records the
    ops of every thread — the engine generates in worker threads, not the
    one that starts a capture — and, where this torch can, exports without
    building Python event objects first."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for extra in ({"profile_all_threads": True, "trace_only": True},
                  {"profile_all_threads": True}, {}):
        try:
            config = _ExperimentalConfig(**extra)
        except TypeError:           # an older torch without the option
            continue
        return profile(activities=activities, experimental_config=config)


def prepare_profiler() -> dict:
    """Pay the profiler's one-time set-up now: with ``LFKT_PROFILE_DIR``
    set, start and stop one profiler (no trace is written) the first time
    this is called in the process; unset, prepared already, or while a
    capture holds the profiler (which pays the set-up itself), do nothing.
    Returns :func:`profiler_prepared`.  A profiler failure is logged, never
    raised — the capture then reports it."""
    if not profile_dir() or _PREPARED["count"]:
        return profiler_prepared()
    if not _CAPTURE_LOCK.acquire(blocking=False):
        return profiler_prepared()
    try:
        if not _PREPARED["count"]:
            t0 = time.time()
            try:
                prof = _profiler()
                prof.start()
                prof.stop()
            except Exception as e:  # noqa: BLE001 — capture is best-effort
                logger.warning("profiler set-up failed (%s)", e)
            _PREPARED["count"] += 1
            _PREPARED["seconds"] = round(time.time() - t0, 3)
            logger.info("profiler prepared in %.3fs", _PREPARED["seconds"])
    finally:
        _CAPTURE_LOCK.release()
    return profiler_prepared()


def profiler_prepared() -> dict:
    """``{"count", "seconds"}``: how many times this process ran the
    profiler's set-up (0 or 1) and how long it took."""
    return dict(_PREPARED)


def _trace_path(d: str, tag: str) -> str:
    return os.path.join(d, f"{tag}-{time.strftime('%Y%m%d-%H%M%S')}-"
                           f"{time.time_ns() % 1_000_000_000:09d}.json")


def capture_profile(seconds: float) -> dict:
    """Bounded on-demand capture (the ``GET /debug/profile`` body): start
    the profiler, hold it for the clamped window, stop, export the Chrome
    trace into ``LFKT_PROFILE_DIR`` and say where it landed.  Blocking —
    callers run it in a worker thread.  Raises :class:`ProfileDisabled`
    when the knob is unset and :class:`ProfileBusy` when the profiler is
    taken; a profiler failure is reported in the result, not raised."""
    d = profile_dir()
    if not d:
        raise ProfileDisabled(
            "set LFKT_PROFILE_DIR to enable /debug/profile captures")
    seconds = max(MIN_CAPTURE_SECONDS, min(MAX_CAPTURE_SECONDS, float(seconds)))
    if not _CAPTURE_LOCK.acquire(blocking=False):
        raise ProfileBusy("a profiler capture is already running")
    try:
        os.makedirs(d, exist_ok=True)
        t0 = time.time()
        try:
            prof = _profiler()
            prof.start()
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            logger.warning("profiler capture unavailable (%s)", e)
            return {"ok": False, "error": str(e), "dir": d}
        path = _trace_path(d, "profile")
        start_s = round(time.time() - t0, 3)
        try:
            time.sleep(seconds)
        finally:
            try:
                prof.stop()
                prof.export_chrome_trace(path)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler teardown failed (%s)", e)
                return {"ok": False, "error": str(e), "dir": d, "seconds": seconds,
                        "wall_s": round(time.time() - t0, 3)}
        # "seconds" is the clamped window; "start_s" the profiler's start
        # before it (CUPTI's set-up the first time), "wall_s" all of it
        # with the stop and the export, which can dwarf a short window
        return {"ok": True, "dir": d, "seconds": seconds, "start_s": start_s,
                "wall_s": round(time.time() - t0, 3), "trace": path}
    finally:
        _CAPTURE_LOCK.release()


@contextlib.contextmanager
def maybe_profile(tag: str = "generate"):
    """A ``torch.profiler`` trace of the body into ``LFKT_PROFILE_DIR``
    when it is set and no other capture runs; otherwise nothing.  Profiler
    failures are logged, never raised; the body's own exceptions
    propagate unchanged."""
    d = profile_dir()
    if not d:
        yield
        return
    if not _CAPTURE_LOCK.acquire(blocking=False):
        yield                      # a capture holds the profiler
        return
    prof = None
    try:
        try:
            os.makedirs(d, exist_ok=True)
            prof = _profiler()
            prof.start()
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            logger.warning("profiler capture unavailable (%s); continuing", e)
            prof = None
        try:
            yield
        finally:
            if prof is not None:
                try:
                    prof.stop()
                    prof.export_chrome_trace(_trace_path(d, tag))
                except Exception as e:  # noqa: BLE001
                    logger.warning("profiler teardown failed (%s); trace dropped", e)
    finally:
        _CAPTURE_LOCK.release()
