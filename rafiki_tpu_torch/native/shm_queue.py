"""ctypes binding of the native shared-memory message queue
(``src/shmqueue.cpp``).

Own copy of ``rafiki_tpu/native/shm_queue.py``: :class:`ShmMessageQueue`
moves byte messages between processes on one host through a POSIX shm
ring. The ring's layout and protocol are the original's, so a ring made
by either package can be attached by the other. Differences:

- No fallback: the library is built at first use and a build that fails
  raises :class:`~rafiki_tpu_torch.native.build.NativeBuildError`
  (the original reported ``available() == False`` to callers that then
  used the in-process broker).
- A ring is reserved in full when it is created, and a shm filesystem
  with no room for it raises :class:`ShmNoSpaceError` at create time.
"""

from __future__ import annotations

import ctypes
import errno
import logging
import os
import threading
import uuid
from typing import Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.native.build import load_library

logger = logging.getLogger(__name__)


def default_capacity() -> int:
    """Ring capacity in bytes: ``RAFIKI_SHM_RING_BYTES`` (default 1 MiB,
    at least 4 KiB), read at each create."""
    return max(int(config.SHM_RING_BYTES), 1 << 12)


def library() -> ctypes.CDLL:
    """The native queue's library, built at first use (raises
    ``NativeBuildError`` when it cannot be built)."""
    lib = load_library("shmqueue")
    if not getattr(lib, "_shmq_configured", False):
        lib.shmq_create.restype = ctypes.c_void_p
        lib.shmq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.shmq_open.restype = ctypes.c_void_p
        lib.shmq_open.argtypes = [ctypes.c_char_p]
        lib.shmq_push.restype = ctypes.c_int
        lib.shmq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint32, ctypes.c_long]
        lib.shmq_pop.restype = ctypes.c_int
        lib.shmq_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_uint32)]
        lib.shmq_used.restype = ctypes.c_uint64
        lib.shmq_used.argtypes = [ctypes.c_void_p]
        lib.shmq_close.restype = None
        lib.shmq_close.argtypes = [ctypes.c_void_p]
        lib.shmq_destroy.restype = None
        lib.shmq_destroy.argtypes = [ctypes.c_void_p]
        lib._shmq_configured = True
    return lib


def make_queue_name(prefix: str = "rafiki") -> str:
    """A fresh shm object name (one component, starting with '/')."""
    return f"/{prefix}-{os.getpid()}-{uuid.uuid4().hex[:12]}"


class ShmQueueClosed(Exception):
    pass


class ShmNoSpaceError(OSError):
    """The shm filesystem (``/dev/shm``) has no room for a ring of this
    size; lower ``RAFIKI_SHM_RING_BYTES`` or give the host more shm."""


class ShmMessageQueue:
    """One MPMC byte-message queue backed by POSIX shared memory."""

    def __init__(self, name: str, capacity: Optional[int] = None,
                 create: bool = True):
        lib = library()
        self._lib = lib
        self.name = name
        if capacity is None:
            capacity = default_capacity()
        if not 0 < capacity < 1 << 32:
            raise ValueError(f"ring capacity {capacity} is not a u32 > 0")
        #: ring size this handle created (0 when attached: the header is
        #: not read back on open)
        self.capacity = capacity if create else 0
        #: high-water mark of ring occupancy seen through this handle's
        #: pushes: how close batched frames come to the ring's size
        self.used_bytes_hw = 0
        if create:
            err = ctypes.c_int(0)
            self._h = lib.shmq_create(name.encode(), capacity,
                                      ctypes.byref(err))
            if not self._h:
                if err.value == errno.ENOSPC:
                    raise ShmNoSpaceError(
                        err.value,
                        f"no room in the shm filesystem for a ring of "
                        f"{capacity} bytes ({name}); lower "
                        f"RAFIKI_SHM_RING_BYTES or enlarge /dev/shm")
                raise OSError(err.value, f"shmq_create({name}) failed: "
                              f"{os.strerror(err.value)}")
        else:
            self._h = lib.shmq_open(name.encode())
            if not self._h:
                raise OSError(f"shmq_open({name}) failed")
        # receive buffers are per thread: a second pop must not overwrite a
        # buffer before the first has read it
        self._tls = threading.local()
        # destroy() must not unmap the segment while another thread is
        # inside shmq_push/pop (a segfault, not an exception)
        self._cv = threading.Condition()
        self._inflight = 0

    def _enter_native(self) -> None:
        with self._cv:
            if not self._h:
                raise ShmQueueClosed(self.name)
            self._inflight += 1

    def _exit_native(self) -> None:
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    def push(self, payload: bytes, timeout_s: float = 5.0) -> None:
        """Raises TimeoutError (ring full past the timeout), ShmQueueClosed,
        or ValueError (a message larger than the ring)."""
        self._enter_native()
        try:
            rc = self._lib.shmq_push(self._h, payload, len(payload),
                                     int(timeout_s * 1000))
            if rc == 0:
                # a fast consumer may pop before shmq_used is sampled; the
                # ring still held this message for a moment
                used = max(int(self._lib.shmq_used(self._h)), len(payload))
                self.used_bytes_hw = max(self.used_bytes_hw, used)
        finally:
            self._exit_native()
        if rc == -1:
            raise TimeoutError("shm queue full")
        if rc == -2:
            raise ShmQueueClosed(self.name)
        if rc == -3:
            raise ValueError(
                f"message of {len(payload)}B exceeds the ring capacity")
        if rc != 0:
            raise RuntimeError(f"shmq_push returned {rc}")

    def pop(self, timeout_s: float = 0.5) -> Optional[bytes]:
        """One message, or None on timeout. Raises ShmQueueClosed once the
        queue is closed and drained."""
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = ctypes.create_string_buffer(64 * 1024)
        required = ctypes.c_uint32(0)
        self._enter_native()
        try:
            rc = self._lib.shmq_pop(self._h, buf, len(buf),
                                    int(timeout_s * 1000),
                                    ctypes.byref(required))
            while rc == -4:
                # grow and retry; with several consumers another (larger)
                # message may be at the head by then, so loop
                buf = self._tls.buf = ctypes.create_string_buffer(
                    int(required.value))
                rc = self._lib.shmq_pop(self._h, buf, len(buf),
                                        int(timeout_s * 1000),
                                        ctypes.byref(required))
        finally:
            self._exit_native()
        if rc == -1:
            return None
        if rc == -2:
            raise ShmQueueClosed(self.name)
        if rc < 0:
            raise RuntimeError(f"shmq_pop returned {rc}")
        return buf.raw[:rc]

    def stats(self) -> dict:
        """Ring occupancy: capacity (0 for an attached handle), bytes in
        the ring, and this handle's push high-water mark."""
        return {"capacity": self.capacity, "used_bytes": self.used_bytes(),
                "used_bytes_hw": self.used_bytes_hw}

    def used_bytes(self) -> int:
        try:
            self._enter_native()
        except ShmQueueClosed:
            return 0
        try:
            return int(self._lib.shmq_used(self._h))
        finally:
            self._exit_native()

    def close(self) -> None:
        """Mark the ring closed for every handle: pops drain, then raise
        ShmQueueClosed; pushes raise it at once."""
        with self._cv:
            if self._h:
                self._lib.shmq_close(self._h)

    def destroy(self) -> None:
        """Unmap (and unlink, if this handle created the segment), after
        in-flight push/pop calls on this handle return (their waits are
        bounded by their timeouts; close() first wakes them at once)."""
        with self._cv:
            if not self._h:
                return
            h, self._h = self._h, None  # new calls now raise ShmQueueClosed
            while self._inflight:
                if not self._cv.wait(timeout=10.0):
                    logger.warning("destroy(%s): %d native calls still in "
                                   "flight", self.name, self._inflight)
                    break
        self._lib.shmq_destroy(h)

    def __del__(self):
        try:
            self.destroy()
        except Exception:  # interpreter teardown: nothing left to report to
            pass
