"""Process-based trial workers — the Ray-actor analogue as real OS processes.

The thread tier (concurrent_executor.py) overlaps *device* work, but host-side
trainable code still serializes on the GIL, and a hung step can only be
abandoned — its thread (and SlicePool slice) leak forever.  This module gives
each trial its own **spawned process**, driven over a pipe with a small command
protocol; because it is a process, the host can ``SIGKILL`` it and reclaim the
slice (DESIGN.md §5).

Three pieces:

- ``TrainableFactory`` — a *spawn-safe* recipe for rebuilding the trainable in
  the child: an importable ``"module:attr"`` target (optionally called with
  args/kwargs to produce the class) plus sys.path entries.  Nothing live
  crosses the boundary — the child re-imports and re-builds.
  ``register_worker_factory``/``resolve_worker_factory`` is the process-tier
  registry mirroring ``register_trainable``.
- The command protocol — parent sends ``STEP`` / ``SAVE`` / ``RESTORE`` /
  ``RESET_CONFIG`` / ``RESIZE`` / ``STOP``; the child replies ``READY`` /
  ``RESULT`` / ``CHECKPOINTED`` / ``SAVED`` / ``RESTORED`` / ``RESET`` /
  ``RESIZED`` / ``STOPPED`` / ``ERROR``.  Checkpoint **bytes**
  (``checkpoint.tree_to_bytes``) travel through the spill surface of an
  ``ObjectStore`` both sides point at — only keys cross the pipe, and no live
  JAX object is ever pickled.  ``RESIZE`` rebuilds the trainable in place
  over a new mesh slice (elastic tier, DESIGN.md §6) without paying a
  process teardown; the parent may also queue up to *k* STEP commands at
  once (lookahead credits) — the pipe itself is the resume gate, so a
  queued STEP costs the child no round-trip wait.
- ``ProcessWorker`` — the parent-side handle: spawn, thread-safe send, kill,
  join.  The child is started with the ``spawn`` method (fork is unsafe once
  JAX/XLA threads exist) and is a daemon, so a dying host reaps its workers.

This module (and everything it imports) stays jax-free at import time: a
worker whose trainable never touches device arrays boots in fractions of a
second instead of paying the jax import.
"""
from __future__ import annotations

import importlib
import io
import itertools
import multiprocessing as mp
import os
import sys
import threading
import time as _time
import traceback
from dataclasses import dataclass, field
from multiprocessing import forkserver
from typing import Any, Dict, Optional, Tuple

from .object_store import ObjectStore

__all__ = [
    "TrainableFactory", "register_worker_factory", "resolve_worker_factory",
    "factory_from_class", "ProcessWorker",
    "CMD_STEP", "CMD_SAVE", "CMD_RESTORE", "CMD_RESET_CONFIG", "CMD_RESIZE",
    "CMD_STOP",
]

# parent -> child commands
CMD_STEP = "STEP"
CMD_SAVE = "SAVE"
CMD_RESTORE = "RESTORE"
CMD_RESET_CONFIG = "RESET_CONFIG"
CMD_RESIZE = "RESIZE"
CMD_STOP = "STOP"

# child -> parent messages
MSG_READY = "READY"
MSG_RESULT = "RESULT"
MSG_CHECKPOINTED = "CHECKPOINTED"
MSG_SAVED = "SAVED"
MSG_RESTORED = "RESTORED"
MSG_RESET = "RESET"
MSG_RESIZED = "RESIZED"
MSG_STOPPED = "STOPPED"
MSG_ERROR = "ERROR"
MSG_SPANS = "SPANS"  # batch of trace spans (repro_torch.obs wire tuples)


@dataclass(frozen=True)
class TrainableFactory:
    """Spawn-safe recipe for building a trainable class in a worker process.

    ``target`` is ``"module:attr"`` (dots allowed in ``attr``).  With
    ``call=True`` the imported attr is called with ``args``/``kwargs`` and must
    return the Trainable class (the ``make_model_trainable`` pattern);
    otherwise the attr *is* the class.  ``sys_path`` entries are prepended in
    the child before the import — how test-local and script-local trainables
    become importable from a fresh interpreter.
    """

    target: str
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    call: bool = False
    sys_path: Tuple[str, ...] = ()

    def resolve(self) -> type:
        for p in reversed(self.sys_path):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        mod_name, _, attr = self.target.partition(":")
        if not attr:
            raise ValueError(f"factory target must be 'module:attr', got {self.target!r}")
        obj: Any = importlib.import_module(mod_name)
        for part in attr.split("."):
            obj = getattr(obj, part)
        if self.call:
            obj = obj(*self.args, **dict(self.kwargs))
        return obj


_WORKER_REGISTRY: Dict[str, TrainableFactory] = {}


def register_worker_factory(name: str, factory: TrainableFactory) -> None:
    """Register a spawn-safe factory under ``name`` (the process-tier analogue
    of ``register_trainable``)."""
    if not isinstance(factory, TrainableFactory):
        raise TypeError(f"expected a TrainableFactory, got {type(factory)}")
    _WORKER_REGISTRY[name] = factory


def resolve_worker_factory(name: str) -> TrainableFactory:
    try:
        return _WORKER_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no worker factory registered for trainable {name!r}; process "
            "workers rebuild the trainable in a fresh interpreter, so register "
            "a spawn-safe recipe with register_worker_factory(name, "
            "TrainableFactory(...)) (for model trainables use "
            "train.trainable.model_trainable_factory)")


def factory_from_class(cls: type) -> Optional[TrainableFactory]:
    """A factory referencing ``cls`` by import path, or None when the class is
    not importable from a fresh interpreter (local classes, ``wrap_function``
    products — those need an explicit factory)."""
    qualname = getattr(cls, "__qualname__", "")
    module = getattr(cls, "__module__", "")
    if not module or not qualname or "<locals>" in qualname or module == "__main__":
        return None
    return TrainableFactory(target=f"{module}:{qualname}")


# ---------------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------------

def _child_store(spec: Dict[str, Any]) -> ObjectStore:
    # Tiny in-memory footprint: the child's store exists only as a window onto
    # the shared spill directory; checkpoint bytes go straight to disk.
    return ObjectStore(capacity_bytes=1 << 20, spill_dir=spec["spill_dir"])


def _decode_state(state: Any) -> Any:
    if isinstance(state, (bytes, bytearray)):
        from .checkpoint import tree_from_bytes
        return tree_from_bytes(bytes(state))
    return state  # a live pytree put there by an in-host executor


def _consume_key(store: ObjectStore, key: str) -> None:
    """Private export-copy payloads (CheckpointManager.export_copy) are
    one-shot: delete after a successful restore so spill files don't pile up.
    Shared keys (a trial's own checkpoints) are left alone."""
    if key.startswith("export/"):
        try:
            store.delete(key)
        except OSError:
            pass


def _child_main(conn, spec: Dict[str, Any]) -> None:
    """Worker process entry: build the trainable, then serve the command loop.

    Every reply is sent before blocking on the next command; the parent's
    resume gate is simply "don't send STEP yet", and lookahead credits are
    simply "queue up to k STEPs" — the child itself never changes behavior,
    it just stops idling between a RESULT and the next command.

    ``conn`` is any Transport: an object with ``send(obj)`` / ``recv()`` /
    ``poll(timeout)`` / ``close()``.  The pipe tier passes a multiprocessing
    Connection; the cluster tier passes a framed SocketTransport whose closed/
    corrupt-peer errors subclass EOFError/OSError, so the exception handling
    below needs no transport-specific branches (repro.cluster.transport).
    """
    trial_id = spec["trial_id"]
    checkpoint_freq = int(spec.get("checkpoint_freq", 0))
    # Child-side tracing (repro_torch.obs): spans are buffered and shipped as ONE
    # MSG_SPANS before the reply they annotate, so the parent's pump adopts
    # them onto the trial's trace row before processing the result.  The
    # child has no injected clock — timestamps are wall time; the process
    # tier never runs under a VirtualClock (DESIGN.md §5/§8).
    trace_on = bool(spec.get("trace"))
    spans: list = []

    def _flush_spans() -> None:
        if spans:
            conn.send((MSG_SPANS, list(spans)))
            spans.clear()

    try:
        nice = int(spec.get("nice", 0))
        if nice > 0 and hasattr(os, "nice"):
            # Data-plane yields to control-plane: trial compute saturates the
            # cores, but the host's pump/runner threads must preempt instantly
            # to turn a RESULT into the next STEP, or every worker idles at
            # the gate for an OS scheduling quantum per step.
            os.nice(nice)
        t_build = _time.time()
        store = _child_store(spec)
        cls = spec["factory"].resolve()
        trainable = cls(dict(spec["config"]))
        restore_key = spec.get("restore_key")
        if restore_key:
            t_res = _time.time()
            trainable.restore(_decode_state(store.get(restore_key)))
            trainable.iteration = int(spec.get("restore_iteration", 0))
            _consume_key(store, restore_key)
            if trace_on:
                spans.append(("ckpt.restore", t_res, _time.time() - t_res,
                              "ckpt", "worker",
                              {"iteration": trainable.iteration}))
        if trace_on:
            spans.append(("build", t_build, _time.time() - t_build,
                          "lifecycle", "worker", {"pid": os.getpid()}))
            _flush_spans()
        conn.send((MSG_READY, os.getpid()))
    except BaseException:  # noqa: BLE001 — report the build failure, then exit
        try:
            conn.send((MSG_ERROR, traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
        return

    save_seq = itertools.count()

    content_addressed = bool(spec.get("cas"))

    def _save_bytes() -> str:
        from .checkpoint import tree_to_bytes
        t0 = _time.time()
        data = tree_to_bytes(trainable.save())
        if content_addressed:
            # Cluster tier: the key IS the payload digest (scoped per trial so
            # keep_last rotation of one trial can never delete another trial's
            # identical bytes).  The controller re-derives the digest after
            # fetching across hosts — a torn or tampered spill file fails the
            # fetch instead of restoring garbage — and identical re-saves
            # (PBT rewinds) dedupe to one spill file.
            import hashlib
            key = f"cas/{trial_id}/{hashlib.sha256(data).hexdigest()}"
        else:
            # Key is unique per save, not just per iteration: a PBT rewind
            # makes a worker re-reach the same iteration and save again, and
            # reusing the key would let the host's LRU serve the stale first
            # payload (and let keep_last rotation of the old Checkpoint delete
            # the new one's data).
            key = (f"ckpt/{trial_id}/{trainable.iteration}."
                   f"{os.getpid()}.{next(save_seq)}")
        key = store.put_spilled(data, key=key)
        if trace_on:
            spans.append(("ckpt.save", t0, _time.time() - t0, "ckpt",
                          "worker", {"iteration": trainable.iteration,
                                     "bytes": len(data)}))
        return key

    done_seen = False
    queued_steps = 0
    stashed = None  # one control command held back behind queued STEPs
    try:
        while True:
            # Lookahead credits queue STEPs in the pipe; count them instead
            # of executing on receipt.  A STOP sent behind k-1 credited STEPs
            # preempts them (teardown beats doomed compute), but every OTHER
            # control command keeps FIFO order with the queued STEPs: a SAVE
            # must observe the state *after* the steps queued before it —
            # the parent relies on that drain-barrier during a resize, and
            # jumping the queue would make the later RESTORE rewind results
            # already produced (duplicate iterations).
            msg = None
            while msg is None:
                if stashed is not None and not queued_steps:
                    msg, stashed = stashed, None
                    break
                if queued_steps and not conn.poll(0):
                    queued_steps -= 1
                    if done_seen:
                        # Credits queued behind a final result: stepping a
                        # finished trainable would be an error; drop them.
                        continue
                    try:
                        t_step = _time.time()
                        metrics = dict(trainable.train())
                        if trace_on:
                            spans.append(("step", t_step,
                                          _time.time() - t_step, "train",
                                          "worker",
                                          {"iteration": trainable.iteration}))
                        done = bool(metrics.pop("done", False))
                        if (checkpoint_freq and not done
                                and trainable.iteration % checkpoint_freq == 0):
                            conn.send((MSG_CHECKPOINTED, _save_bytes(),
                                       trainable.iteration))
                    except Exception:  # noqa: BLE001 — trial, not framework, error
                        conn.send((MSG_ERROR, traceback.format_exc()))
                        return
                    done_seen = done
                    _flush_spans()
                    conn.send((MSG_RESULT, trainable.iteration, metrics, done))
                    continue
                nxt = conn.recv()
                if nxt[0] == CMD_STEP:
                    queued_steps += 1
                elif nxt[0] == CMD_STOP or not queued_steps:
                    msg = nxt
                else:
                    stashed = nxt  # at most one: sync exchanges are serial
            # Only control commands reach the dispatch: the receive loop
            # above counts STEPs into queued_steps and never yields one.
            cmd = msg[0]
            if cmd == CMD_RESIZE:
                # Elastic slice resize (DESIGN.md §6): rebuild the trainable
                # over the new mesh window and restore the just-saved state —
                # all inside this warm process, no teardown.  Failure is
                # NON-fatal: the old trainable keeps serving and the parent
                # rolls the pool back (trial falls back to its old slice).
                _, new_config, key, iteration = msg
                resized = None
                try:
                    state = _decode_state(store.get(key))
                    resized = cls(dict(new_config))
                    resized.restore(state)
                    resized.iteration = int(iteration)
                except Exception:  # noqa: BLE001 — keep the old trainable
                    if resized is not None:  # built but failed to restore
                        try:
                            resized.cleanup()
                        except Exception:  # noqa: BLE001
                            pass
                    conn.send((MSG_RESIZED, False, traceback.format_exc()))
                else:
                    old = trainable
                    trainable = resized
                    try:
                        old.cleanup()
                    except Exception:  # noqa: BLE001
                        pass
                    conn.send((MSG_RESIZED, True, None))
            elif cmd == CMD_SAVE:
                try:
                    key = _save_bytes()
                    _flush_spans()
                    conn.send((MSG_SAVED, key, trainable.iteration))
                except Exception:  # noqa: BLE001
                    conn.send((MSG_ERROR, traceback.format_exc()))
                    return
            elif cmd == CMD_RESTORE:
                _, key, iteration = msg
                try:
                    t_res = _time.time()
                    trainable.restore(_decode_state(store.get(key)))
                    trainable.iteration = int(iteration)
                    _consume_key(store, key)
                    if trace_on:
                        spans.append(("ckpt.restore", t_res,
                                      _time.time() - t_res, "ckpt", "worker",
                                      {"iteration": int(iteration)}))
                        _flush_spans()
                    conn.send((MSG_RESTORED, int(iteration)))
                except Exception:  # noqa: BLE001
                    conn.send((MSG_ERROR, traceback.format_exc()))
                    return
            elif cmd == CMD_RESET_CONFIG:
                _, new_config = msg
                try:
                    ok = bool(trainable.reset_config(dict(new_config)))
                    if ok:
                        trainable.config = dict(new_config)
                except Exception:  # noqa: BLE001
                    conn.send((MSG_ERROR, traceback.format_exc()))
                    return
                conn.send((MSG_RESET, ok))
            elif cmd == CMD_STOP:
                try:
                    trainable.cleanup()
                except Exception:  # noqa: BLE001
                    pass
                conn.send((MSG_STOPPED,))
                return
            else:
                conn.send((MSG_ERROR, f"unknown worker command {cmd!r}"))
                return
    except (EOFError, KeyboardInterrupt, BrokenPipeError, OSError):
        # parent vanished or killed us mid-send; nothing left to report to
        return
    finally:
        try:
            conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------------

_DEFAULT_CTX: Optional[Any] = None


class _ForkServer(forkserver.ForkServer):
    """``multiprocessing``'s forkserver, first launched with this process's
    ``sys.path`` as its ``PYTHONPATH``.  The server is a fresh interpreter;
    newer Pythons hand it the parent's ``sys.path``, but 3.12.3's ignores
    it, so this module is not importable there, the preload fails silently
    and every worker imports torch and this package itself: seconds a
    worker on a GPU host."""

    _env_lock = threading.Lock()

    def ensure_running(self):
        if self._forkserver_pid is not None:
            return super().ensure_running()
        with self._env_lock:
            saved = os.environ.get("PYTHONPATH")
            os.environ["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
            try:
                super().ensure_running()
            finally:
                if saved is None:
                    del os.environ["PYTHONPATH"]
                else:
                    os.environ["PYTHONPATH"] = saved


class _ForkServerContext(mp.context.BaseContext):
    """A ``forkserver`` context with a server of its own.

    ``multiprocessing`` keeps one forkserver per process, and its preload list
    is fixed when it first starts.  A process that also runs the JAX
    package's process executor would otherwise fork the port's workers from
    an image that preloaded ``repro.core.workers`` (or the JAX workers from
    this package's), whichever started first.  The server never touches CUDA:
    it only imports this module, and importing torch initialises no device.
    """

    _name = "forkserver"

    def __init__(self, preload: list):
        self.server = _ForkServer()
        self.server.set_forkserver_preload(preload)
        self.Process = _ForkServerProcess


class _ForkServerProcess(mp.process.BaseProcess):
    """A worker forked by ``_ForkServerContext``'s server.  Pickled by
    reference into the child, so it lives at module level."""

    _start_method = "forkserver"

    @staticmethod
    def _Popen(process_obj):
        from multiprocessing import forkserver, popen_forkserver, spawn, util
        from multiprocessing.context import reduction, set_spawning_popen

        server = _default_context().server

        class Popen(popen_forkserver.Popen):
            def _launch(self, process_obj):
                # popen_forkserver.Popen._launch, connected to ``server``
                # rather than to the process-wide one.
                prep_data = spawn.get_preparation_data(process_obj._name)
                buf = io.BytesIO()
                set_spawning_popen(self)
                try:
                    reduction.dump(prep_data, buf)
                    reduction.dump(process_obj, buf)
                finally:
                    set_spawning_popen(None)
                self.sentinel, w = server.connect_to_new_process(self._fds)
                _parent_w = os.dup(w)
                self.finalizer = util.Finalize(self, util.close_fds,
                                               (_parent_w, self.sentinel))
                with open(w, "wb", closefd=True) as f:
                    f.write(buf.getbuffer())
                self.pid = forkserver.read_signed(self.sentinel)

        return Popen(process_obj)


def _default_context():
    """The cheapest safe multiprocessing context on this platform.

    Preferred: ``forkserver`` with this module preloaded — the server process
    imports repro_torch.core once, then every worker is a ~tens-of-ms fork of that
    warm, thread-free image (fork is safe there: the server never starts JAX
    or any thread).  Plain ``fork`` from the *host* is NOT safe — the host has
    JAX/XLA and executor threads — and plain ``spawn`` re-imports the host's
    ``__main__`` plus the whole stack in every single worker (~1-2s per
    trial).  Falls back to ``spawn`` where forkserver is unavailable.
    """
    global _DEFAULT_CTX
    if _DEFAULT_CTX is None:
        # A server of the port's own (_ForkServerContext), not the
        # process-wide one that the original configures here.
        if "forkserver" in mp.get_all_start_methods():
            _DEFAULT_CTX = _ForkServerContext(["repro_torch.core.workers"])
        else:  # platform without forkserver
            _DEFAULT_CTX = mp.get_context("spawn")
    return _DEFAULT_CTX


class ProcessWorker:
    """Parent-side handle on one spawned trial worker.

    ``send`` is thread-safe (the executor's pump thread kicks READY workers
    while the runner thread drives lifecycle commands).  ``kill`` is the
    reclamation path the thread tier cannot offer: SIGKILL, join, done —
    whatever the child was stuck in, its slice is free again.
    """

    def __init__(
        self,
        factory: TrainableFactory,
        trial_id: str,
        config: Dict[str, Any],
        spill_dir: str,
        checkpoint_freq: int = 0,
        restore_key: Optional[str] = None,
        restore_iteration: int = 0,
        mp_context: Optional[str] = None,
        nice: int = 1,
        trace: bool = False,
    ):
        spec = {
            "factory": factory,
            "trial_id": trial_id,
            "config": config,
            "spill_dir": spill_dir,
            "checkpoint_freq": checkpoint_freq,
            "restore_key": restore_key,
            "restore_iteration": restore_iteration,
            "nice": nice,
            "trace": trace,
        }
        ctx = mp.get_context(mp_context) if mp_context else _default_context()
        self.conn, child_conn = ctx.Pipe(duplex=True)
        # A duplex Pipe Connection already satisfies the Transport surface
        # (send/recv/poll/close + itself as the waitable): ``transport`` is
        # what the executor pump multiplexes on, and subclasses (the cluster
        # tier's socket workers) swap in a framed SocketTransport without the
        # pump or ``_child_main`` noticing.
        self.transport: Any = self.conn
        self.process = ctx.Process(
            target=_child_main, args=(child_conn, spec),
            name=f"repro-worker-{trial_id}", daemon=True)
        self._send_lock = threading.Lock()
        self.process.start()
        child_conn.close()  # child end belongs to the child now

    @property
    def pid(self) -> Optional[int]:
        return self.process.pid

    def alive(self) -> bool:
        return self.process.is_alive()

    def send(self, *msg: Any) -> bool:
        """Best-effort command send; False when the transport is already
        dead.  EOFError covers framed transports signalling a closed peer."""
        try:
            with self._send_lock:
                self.transport.send(msg)
            return True
        except (BrokenPipeError, OSError, ValueError, EOFError):
            return False

    def join(self, timeout: Optional[float] = None) -> bool:
        self.process.join(timeout=timeout)
        return not self.process.is_alive()

    def kill(self, join_timeout: float = 5.0) -> None:
        """SIGKILL the worker and reap it.  Unlike an abandoned thread, this
        *reclaims* the straggler: the process is gone, so its sub-mesh can be
        handed to another trial immediately."""
        try:
            self.process.kill()
        except (OSError, AttributeError, ValueError):
            pass
        self.process.join(timeout=join_timeout)
        self.close()

    def close(self) -> None:
        try:
            self.transport.close()
        except OSError:
            pass
