"""The ranks of a data group: one process a device, under
``torch.distributed``.

The JAX package trains and serves over several chips from one process:
``jit`` runs over a mesh whose data axis is the grant
(``rafiki_tpu/sdk/jax_backend.py``). The port runs one process a card. A
worker granted ``n`` devices is rank 0 of a group it starts with
:class:`Ranks`: ``n - 1`` follower processes (``multiprocessing``'s
``spawn``, a fresh interpreter, never a fork of a process that may have
touched CUDA), follower ``r`` on ``devices[r]``, and one process group
over them (NCCL for CUDA devices, gloo for CPU entries), which meet at a
``TCPStore`` that rank 0 opens on 127.0.0.1 at a free port. Every rank
of a CUDA grant sees the whole grant and picks its card by rank, so
NCCL keeps its peer-to-peer paths between them. The worker keeps its
ranks for all its trials and starts them again after a fault.

Rank 0 is the trial: it alone talks to the store and the advisor, logs,
and writes parameters and checkpoints. A follower runs the same template
calls on its own device, in the order rank 0 sends them over its pipe
(:meth:`Ranks.new_model`, :meth:`Ranks.call`, :meth:`Ranks.load`), and
the trainer (``sdk/torch_backend.py``) keeps the ranks in step through
the group's collectives, which it finds with :func:`current_group`. A
verdict that ends a fit early is rank 0's alone, so it is delivered
only where the trainer hands it to every rank (:func:`verdict_point`).
:meth:`Ranks.each` is the other kind of call: every rank answers its own
part alone, outside the group, as a serving worker splits a batch.

Faults. A follower's exception is sent back and raised on rank 0, where
it is classified as the same exception raised there would be; the
follower then exits. While rank 0 runs its own part of a call, a thread
watches the followers' pipes and processes: a follower's error or death
aborts the group's communicators on rank 0, so a collective rank 0 waits
in fails at once (gloo needs no abort: a peer's exit closes its
connections). A follower that hangs ends rank 0's collective by the
group's timeout (``config.DIST_TIMEOUT_S``, read at each use): NCCL's
asynchronous error handling stays on, set to abort the communicators and
raise in the caller without ending the process, which may be an admin
hosting other jobs. Every wait on a pipe is bounded. After a fault the
ranks are :attr:`Ranks.broken` and the worker starts them again.

Each follower logs a ``startup`` line and, at exit, a ``kernel launches
(pid N): {...}`` line to the standard error it shares with rank 0's
process (a process-placed worker's log), as a worker process does.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import importlib
import json
import logging
import multiprocessing
import os
import pickle
import threading
import time
import traceback
from multiprocessing.connection import wait as wait_any
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from rafiki_tpu_torch import config
from rafiki_tpu_torch.device import DeviceSpec, _as_device, set_device_grant
from rafiki_tpu_torch.parallel.mesh import make_mesh
from rafiki_tpu_torch.worker.faults import FaultKind, TrialFault

logger = logging.getLogger(__name__)

#: seconds a reply may take beyond the group's timeout once rank 0's own
#: part of a call is done, and once it has raised (its followers are then
#: waiting on it in a collective, or have sent their own error already)
_REPLY_MARGIN_S = 30.0
_REPLY_AFTER_ERROR_S = 2.0

_tls = threading.local()


def set_group(group: Optional["DataGroup"]) -> None:
    """Make ``group`` this thread's data group (``None`` clears it)."""
    _tls.group = group


def current_group() -> Optional["DataGroup"]:
    """This thread's data group, or ``None`` on a single device."""
    return getattr(_tls, "group", None)


@contextlib.contextmanager
def alone() -> Iterator[None]:
    """This thread outside its data group for the block: each rank works
    on its own (:meth:`Ranks.each`)."""
    group = current_group()
    set_group(None)
    try:
        yield
    finally:
        set_group(group)


@contextlib.contextmanager
def verdict_point() -> Iterator[None]:
    """The block is where the trainer hands rank 0's verdict to every
    rank (a fit's per-epoch report)."""
    _tls.verdict = True
    try:
        yield
    finally:
        _tls.verdict = False


def in_step() -> bool:
    """Whether a verdict raised here ends every rank's work alike: always
    on one device; over several, only inside :func:`verdict_point` (a
    verdict raised elsewhere on rank 0 leaves the followers waiting in a
    collective)."""
    return current_group() is None or getattr(_tls, "verdict", False)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(config.DIST_TIMEOUT_S))


class DataGroup:
    """One rank's handle on the process group: its rank, the group's
    size, its device, and the collectives the trainer uses (sum, copy
    from a root, gather in rank order, an exchange between pairs).
    :meth:`subgroup` makes the group of a few of its ranks (a line of a
    train mesh, ``parallel/collectives.py``)."""

    def __init__(self, backend: Any, rank: int, size: int,
                 device: torch.device, store: Any = None):
        self._backend = backend
        self.rank = rank
        self.size = size
        self.device = device
        self._store = store
        self._subgroups = 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._run(lambda: self._backend.allreduce([t], opts))
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Copy rank ``src``'s ``t`` into every rank's, in place."""
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        self._run(lambda: self._backend.broadcast([t], opts))
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on all), stacked in rank order."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self._run(lambda: self._backend.allgather([outs], [t]))
        return torch.stack(outs)

    def exchange(self, send: Optional[torch.Tensor], dst: Optional[int],
                 src: Optional[int], shape: Sequence[int] = (),
                 dtype: Optional[torch.dtype] = None
                 ) -> Optional[torch.Tensor]:
        """One step of a permutation: send ``send`` to rank ``dst`` and
        receive a tensor of ``shape`` and ``dtype`` from rank ``src``
        (either may be None: nothing to send, or to receive). Every rank
        of the group calls it together; it is one all-to-all with a part
        for each pair that talks, so a ring of sends cannot deadlock."""
        dtype = dtype or (send.dtype if send is not None else torch.float32)
        n = self.size
        into, out_of = [0] * n, [0] * n
        flat = (send.contiguous().reshape(-1) if send is not None else
                torch.empty(0, dtype=dtype, device=self.device))
        if send is not None:
            out_of[dst] = flat.numel()
        numel = 1
        for d in shape:
            numel *= int(d)
        got = torch.empty(numel if src is not None else 0, dtype=dtype,
                          device=self.device)
        if src is not None:
            into[src] = numel
        self._run(lambda: self._backend.alltoall_base(
            got, flat, into, out_of, dist.AllToAllOptions()))
        return got.view(tuple(shape)) if src is not None else None

    def subgroup(self, ranks: Sequence[int]) -> "DataGroup":
        """The group of ``ranks`` (this rank among them), made by those
        ranks alone, which must make their common groups in the same
        order: the store's keys are numbered by this group's count of
        subgroups made so far."""
        if self._store is None:
            raise ValueError("this group keeps no store to make a "
                             "subgroup with")
        self._subgroups += 1
        tag = f"sub{self._subgroups}/" + ",".join(str(r) for r in ranks)
        return _make_group(dist.PrefixStore(tag, self._store),
                           list(ranks).index(self.rank), len(ranks),
                           self.device)

    def _run(self, start: Callable[[], Any]) -> None:
        """Start a collective and wait for it (on the card: queue it on
        the stream). Its failure is the platform's: a peer lost or past
        the group's timeout, or the group aborted."""
        try:
            start().wait()
        except Exception as e:
            raise TrialFault(
                f"a collective failed on rank {self.rank} of {self.size}: "
                f"{type(e).__name__}: {e}", kind=FaultKind.INFRA) from e

    def abort(self) -> None:
        """End this rank's pending and later collectives with an error:
        NCCL's communicators are aborted. gloo needs none: a peer's exit
        closes its connections and its collectives fail at once."""
        if self._backend is not None and self.device.type == "cuda":
            self._backend.abort()

    def close(self) -> None:
        """Drop the group. NCCL's communicators are aborted (a destroy
        may wait on peers that are gone); gloo's close with it."""
        self.abort()
        self._backend = None


def _make_group(store: Any, rank: int, size: int,
                device: torch.device) -> DataGroup:
    timeout = _timeout()
    if device.type == "cuda":
        # a failed or timed-out collective aborts the communicators and
        # raises in the caller, and leaves the process up (the default
        # ends it from NCCL's watchdog thread), without first waiting a
        # minute for a flight-recorder dump; read as the group is made
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "2"
        os.environ["TORCH_NCCL_DUMP_ON_TIMEOUT"] = "0"
        os.environ["TORCH_NCCL_TRACE_BUFFER_SIZE"] = "0"
        os.environ["TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC"] = "1000"
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        backend = dist.ProcessGroupNCCL(store, rank, size, opts)
        # bound to its card now: the communicators come up here, with the
        # group, not at the first collective
        connect = getattr(backend, "eager_connect_single_device", None)
        if connect is not None:
            connect(device)
    else:
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        backend = dist.ProcessGroupGloo(store, rank, size, opts)
    return DataGroup(backend, rank, size, device, store)


def _fn_name(fn: Callable) -> str:
    return f"{fn.__module__}:{fn.__qualname__}"


def _resolve_fn(name: str) -> Callable:
    module, qualname = name.split(":", 1)
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def launch_counts() -> Dict[str, int]:
    """The attention kernels' launch counters in this process."""
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    from rafiki_tpu_torch.worker.bootstrap import KERNELS

    return {name: getattr(fa, name).launches for name in KERNELS}


def reset_launches() -> None:
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    from rafiki_tpu_torch.worker.bootstrap import KERNELS

    for name in KERNELS:
        getattr(fa, name).launches = 0


def release_device_memory() -> None:
    """Free what a finished or failed trial left on this rank's device:
    cycles among its frames wait for the collector, and a cached
    trainer's dataset upload outlives the trial."""
    from rafiki_tpu_torch.sdk.torch_backend import drop_fit_data

    drop_fit_data()
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class _Follower:
    def __init__(self, rank: int, proc: Any, conn: Any):
        self.rank = rank
        self.proc = proc
        self.conn = conn


class _Dead(Exception):
    pass


class Ranks:
    """Rank 0's side of a data group: the group and the followers' pipes.

    ``Ranks(devices)`` starts the followers and the group and returns when
    every rank is up (bounded by the group's timeout; a follower that
    exits before the group forms raises at once); ``startups`` holds
    each follower's wall-clock stamps and ``init_s`` the seconds from the
    first spawn to the last rank up. Use as a context manager, or call
    :meth:`close`."""

    def __init__(self, devices: Sequence[DeviceSpec]):
        mesh = make_mesh(devices=devices)
        self.devices: List[str] = [str(d) for d in mesh.devices]
        self.size = mesh.size
        self.broken = False
        self.startups: List[Dict[str, Any]] = []
        self.group: Optional[DataGroup] = None
        self._followers: List[_Follower] = []
        # replies the watcher read while rank 0 ran its part of a call
        self._inbox: Dict[int, tuple] = {}
        t0 = time.time()
        timeout = _timeout()
        # the store lives as long as the group: NCCL meets its peers there
        self._store = dist.TCPStore("127.0.0.1", 0, self.size, True,
                                    timeout=timeout, wait_for_workers=False)
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(1, self.size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_follower_main, name=f"rafiki-rank{r}",
                    args=(r, self.size, self._store.port, self.devices,
                          child), daemon=True)
                proc.start()
                child.close()
                self._followers.append(_Follower(r, proc, parent))
            self.group = self._join(mesh.devices[0], timeout)
            for f in self._followers:
                msg = self._recv(f, timeout.total_seconds())
                self.startups.append(msg[1])
        except BaseException:
            self.broken = True
            self.close()
            raise
        self.init_s = time.time() - t0
        logger.info("ranks up on %s in %.2f s: %s", self.devices,
                    self.init_s, json.dumps(self.startups))

    def _join(self, device: torch.device,
              timeout: datetime.timedelta) -> DataGroup:
        """Rank 0's part of the group, formed on a helper thread while the
        followers' processes are watched: a follower that exits before it
        joins (it could not import its main module, or failed on its
        device) raises at once, naming its rank and exit code, where the
        store would otherwise wait for it until the group's timeout. The
        helper is then left to that timeout, which ends it."""
        box: Dict[str, Any] = {}

        def form() -> None:
            try:
                box["group"] = _make_group(self._store, 0, self.size, device)
            except BaseException as e:  # handed to the caller below
                box["error"] = e

        helper = threading.Thread(target=form, name="rafiki-ranks-join",
                                  daemon=True)
        helper.start()
        sentinels = {f.proc.sentinel: f for f in self._followers}
        deadline = time.monotonic() + timeout.total_seconds() \
            + _REPLY_MARGIN_S
        while helper.is_alive():
            for ready in wait_any(list(sentinels), timeout=0.1):
                f = sentinels[ready]
                f.proc.join(timeout=1.0)
                raise TrialFault(
                    f"rank {f.rank} (pid {f.proc.pid}) of {self.devices} "
                    f"exited with code {f.proc.exitcode} before the group "
                    "formed", kind=FaultKind.INFRA)
            if not sentinels:
                helper.join(timeout=0.1)
            if time.monotonic() > deadline:
                raise TrialFault(
                    f"the group over {self.devices} did not form within "
                    f"{timeout.total_seconds():.0f} s", kind=FaultKind.INFRA)
        if "error" in box:
            raise box["error"]
        return box["group"]

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def pids(self) -> List[int]:
        return [f.proc.pid for f in self._followers]

    # -- calls ---------------------------------------------------------------

    def new_model(self, model_file_bytes: bytes, model_class: str,
                  knobs: Dict[str, Any], **attrs: Any) -> None:
        """Each follower builds its own instance of the template class
        with ``knobs`` and sets ``attrs`` on it (``checkpoint_path``)."""
        self._send(("model", model_file_bytes, model_class, knobs, attrs))
        self._settle(None)

    def new_fused(self, members: List[tuple], task: Optional[str]) -> None:
        """Each follower builds its own fused ensemble of ``members``
        (``(template bytes, class name, knobs, params path)`` each, as
        ``worker/inference.load_fused`` takes them) as its model."""
        self._send(("fused", members, task))
        self._settle(None)

    def call(self, model: Any, method: str, *args: Any) -> Any:
        """``model.<method>(*args)`` on every rank, each on its own
        instance; returns rank 0's result (the followers' are dropped)."""
        self._send(("call", method, args))
        return self._run_local(lambda: getattr(model, method)(*args))[0]

    def each(self, model: Any, method: str,
             parts: Sequence[Optional[tuple]]) -> List[Any]:
        """``model.<method>(*parts[r])`` on each rank ``r``, alone (outside
        the group: no collective, so each part has its own size); a rank
        whose part is None is left out. Returns the results in rank order
        (None where left out). A follower's part goes down its pipe. A
        rank's exception is raised here and leaves the ranks whole: no
        collective waits on the rank that raised."""
        called = [f for f in self._followers if parts[f.rank] is not None]
        for f in called:
            self._send(("each", method, parts[f.rank]), [f])

        def local() -> Any:
            if parts[0] is None:
                return None
            with alone():
                return getattr(model, method)(*parts[0])

        result, replies = self._run_local(local, called, breaks=False)
        return [result] + [replies.get(r) for r in range(1, self.size)]

    def load(self, model: Any, params_path: str) -> None:
        """Every rank loads the parameters artifact at ``params_path``
        (rank 0 into ``model``), each reading the file itself."""
        self._send(("load", params_path))
        self._run_local(lambda: load_params_file(model, params_path))

    def drop_model(self, model: Any) -> None:
        """Every rank drops its instance and frees its device memory."""
        self._send(("drop",))
        self._run_local(lambda: (model.destroy(), release_device_memory()))

    def run(self, fn: Callable, *args: Any) -> List[Any]:
        """``fn(*args)`` on every rank (``fn`` a module-level function,
        found by its import path); returns every rank's result in rank
        order."""
        self._send(("fn", _fn_name(fn), args))
        result, replies = self._run_local(lambda: fn(*args))
        return [result] + [replies[r] for r in range(1, self.size)]

    # -- the pipes -----------------------------------------------------------

    def _send(self, msg: tuple,
              followers: Optional[List[_Follower]] = None) -> None:
        if self.broken:
            raise TrialFault("the ranks are broken by an earlier fault; "
                             "start them again", kind=FaultKind.INFRA)
        for f in self._followers if followers is None else followers:
            try:
                f.conn.send(msg)
            except (OSError, ValueError) as e:
                self.broken = True
                raise TrialFault(self._death(f), kind=FaultKind.INFRA) from e

    def _run_local(self, fn: Callable[[], Any],
                   followers: Optional[List[_Follower]] = None,
                   breaks: bool = True) -> tuple:
        """(rank 0's ``fn()``, the followers' replies by rank), the
        followers watched while ``fn`` runs. With ``breaks`` an exception
        on any rank leaves the ranks broken; without, only a death or
        silence does."""
        followers = self._followers if followers is None else followers
        try:
            with self._watch(followers, breaks):
                result = fn()
        except Exception as e:
            self._settle(e, followers, breaks)
            raise
        return result, self._settle(None, followers, breaks)

    @contextlib.contextmanager
    def _watch(self, followers: List[_Follower],
               breaks: bool) -> Iterator[None]:
        """A thread that reads the followers' replies while rank 0 runs
        its part of a call, keeps them for :meth:`_settle`, and aborts the
        group at a follower's death, or its error where ``breaks``: NCCL
        would otherwise wait for the lost peer until the group's
        timeout."""
        stop = threading.Event()
        thread = threading.Thread(target=self._watcher,
                                  args=(followers, breaks, stop),
                                  daemon=True,
                                  name="rafiki-ranks-watch")
        thread.start()
        try:
            yield
        finally:
            stop.set()
            thread.join()

    def _watcher(self, followers: List[_Follower], breaks: bool,
                 stop: threading.Event) -> None:
        waiting = {}
        for f in followers:
            waiting[f.conn] = waiting[f.proc.sentinel] = f
        while waiting and not stop.is_set():
            for ready in wait_any(list(waiting), timeout=0.1):
                f = waiting.get(ready)
                if f is None:
                    continue  # its pipe and its exit, both ready
                del waiting[f.conn], waiting[f.proc.sentinel]
                try:
                    # a follower that exits sends its reply first
                    msg = f.conn.recv() if f.conn.poll(0) else ("dead",)
                except (EOFError, OSError):
                    msg = ("dead",)
                self._inbox[f.rank] = msg
                if msg[0] == "dead" or (msg[0] == "error" and breaks):
                    logger.warning("rank %d failed or died; aborting the "
                                   "group", f.rank)
                    self.group.abort()
                    return

    def _recv(self, f: _Follower, timeout_s: float) -> tuple:
        """The follower's next message, waiting at most ``timeout_s``;
        :class:`_Dead` when it has exited, TimeoutError past the bound."""
        msg = self._inbox.pop(f.rank, None)
        if msg is not None:
            if msg[0] == "dead":
                raise _Dead()
            return msg
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                if f.conn.poll(min(0.2, max(deadline - time.monotonic(),
                                            0))):
                    return f.conn.recv()
            except (EOFError, OSError):
                raise _Dead() from None
            if not f.proc.is_alive() and not f.conn.poll(0):
                raise _Dead()
            if time.monotonic() >= deadline:
                raise TimeoutError()

    def _death(self, f: _Follower) -> str:
        f.proc.join(timeout=1.0)
        return (f"rank {f.rank} (pid {f.proc.pid}) of {self.devices} died "
                f"with exit code {f.proc.exitcode}")

    def _settle(self, local: Optional[BaseException],
                followers: Optional[List[_Follower]] = None,
                breaks: bool = True) -> Dict[int, Any]:
        """Collect each follower's reply to the call just made. Rank 0's
        own exception (``local``) is the caller's to raise, unless a
        follower's error or death caused it: then that is raised. A
        follower that does not answer in time is a fault too."""
        # a call without collectives: the followers answer in their own
        # time, whatever rank 0 did
        wait = (float(config.DIST_TIMEOUT_S) + _REPLY_MARGIN_S
                if local is None or not breaks else _REPLY_AFTER_ERROR_S)
        results: Dict[int, Any] = {}
        # a follower's own failure beats a death or silence it brought on
        error: Optional[BaseException] = None
        lost: Optional[BaseException] = None
        for f in self._followers if followers is None else followers:
            try:
                msg = self._recv(f, wait)
            except _Dead:
                lost = lost or TrialFault(self._death(f),
                                          kind=FaultKind.INFRA)
                continue
            except TimeoutError:
                if local is None:
                    lost = lost or TrialFault(
                        f"rank {f.rank} (pid {f.proc.pid}) did not answer "
                        f"within {wait:.0f} s", kind=FaultKind.INFRA)
                continue
            if msg[0] == "error":
                error = error or _rebuild_error(f.rank, f.proc.pid, *msg[1:])
            else:
                results[f.rank] = msg[1]
        self._inbox.clear()
        cause = error or lost
        if lost is not None or (breaks and (
                local is not None or cause is not None)):
            self.broken = True
        if cause is not None:
            raise cause from local
        return results

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        """Stop the followers (each logs its kernel launches and leaves)
        and drop the group. Broken ranks are killed: they may be waiting
        in a collective that will never complete."""
        grace = 0.0 if self.broken else 10.0
        for f in self._followers:
            if grace:
                try:
                    f.conn.send(("exit",))
                except (OSError, ValueError):
                    pass
        for f in self._followers:
            f.proc.join(timeout=grace)
            if f.proc.is_alive():
                f.proc.terminate()
                f.proc.join(timeout=5.0)
            if f.proc.is_alive():
                f.proc.kill()
                f.proc.join(timeout=5.0)
            f.conn.close()
        self._followers = []
        if self.group is not None:
            self.group.close()
            self.group = None
        self._store = None


def _rebuild_error(rank: int, pid: int, blob: Optional[bytes],
                   type_name: str, message: str, tb: str) -> BaseException:
    """The follower's exception as rank 0 raises it: the same type and
    message where it unpickles (bytes a follower of this program wrote),
    else a RuntimeError naming them; the follower's traceback as a
    note."""
    exc: Any = None
    if blob is not None:
        try:
            exc = pickle.loads(blob)
        except Exception:
            exc = None
    if not isinstance(exc, Exception):
        exc = RuntimeError(f"{type_name}: {message}")
    exc.add_note(f"raised on rank {rank} (pid {pid}):\n{tb}")
    return exc


def load_params_file(model: Any, params_path: str) -> None:
    """``model.load_parameters`` of the verified artifact at
    ``params_path`` (a damaged file raises ``ArtifactCorruptError``)."""
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.params import load_params

    model.load_parameters(load_params(read_artifact(params_path)))


# -- the follower process -------------------------------------------------


def _follower_main(rank: int, size: int, port: int, devices: List[str],
                   conn: Any) -> None:
    stamps = {"t_main": time.time()}
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(levelname)s:%(asctime)s:rank{rank}:%(name)s: %(message)s")
    from rafiki_tpu_torch.worker.bootstrap import _process_start_time

    stamps["t_start"] = _process_start_time()
    device = _as_device(devices[rank])
    set_device_grant([devices[rank]])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    stamps["t_cuda"] = time.time()
    store = dist.TCPStore("127.0.0.1", port, size, False, timeout=_timeout())
    group = _make_group(store, rank, size, device)
    set_group(group)
    stamps["t_group"] = time.time()
    startup = {"rank": rank, "pid": os.getpid(), "device": str(device),
               **stamps}
    logger.info("startup (pid %d): %s", os.getpid(), json.dumps(startup))
    conn.send(("ready", startup))
    state: Dict[str, Any] = {"model": None}
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                logger.warning("rank 0 is gone; leaving")
                return
            if msg[0] == "exit":
                return
            try:
                conn.send(("ok", _dispatch(state, msg)))
            except Exception as e:
                try:
                    blob: Optional[bytes] = pickle.dumps(e)
                except Exception:
                    blob = None
                logger.error("rank %d failed %s:\n%s", rank, msg[0],
                             traceback.format_exc())
                conn.send(("error", blob, type(e).__name__, str(e),
                           traceback.format_exc()))
                if msg[0] != "each":
                    # leave now: the peers' next collective fails at once
                    return
    finally:
        logger.info("kernel launches (pid %d): %s", os.getpid(),
                    json.dumps(launch_counts()))
        set_group(None)
        group.close()
        del store


def _dispatch(state: Dict[str, Any], msg: tuple) -> Any:
    kind = msg[0]
    if kind == "model":
        from rafiki_tpu_torch.sdk.log import ModelLogger
        from rafiki_tpu_torch.sdk.model import load_model_class

        _, model_bytes, class_name, knobs, attrs = msg
        model = load_model_class(model_bytes, class_name)(**knobs)
        model.logger = ModelLogger()  # rank 0 alone logs
        for k, v in attrs.items():
            setattr(model, k, v)
        state["model"] = model
        return None
    if kind == "fused":
        from rafiki_tpu_torch.worker.inference import load_fused

        state["model"] = load_fused(msg[1], msg[2])
        return None
    if kind == "call":
        _, method, args = msg
        getattr(state["model"], method)(*args)
        return None
    if kind == "each":
        _, method, args = msg
        with alone():
            return getattr(state["model"], method)(*args)
    if kind == "load":
        load_params_file(state["model"], msg[1])
        return None
    if kind == "drop":
        model, state["model"] = state["model"], None
        if model is not None:
            model.destroy()
        release_device_memory()
        return None
    if kind == "fn":
        _, name, args = msg
        return _resolve_fn(name)(*args)
    raise ValueError(f"unknown rank command {kind!r}")
