"""The port's shared-memory data plane on the CPU: the native queue
(``rafiki_tpu_torch/native/``) and the shm broker
(``rafiki_tpu_torch/cache/shm_broker.py``), against the JAX package's.

- The native queue: FIFO order, timeouts, wraparound, messages larger
  than the receive buffer, close, and attach from another process.
- The ring protocol is the original's: a ring the port creates is used by
  ``rafiki_tpu.native.shm_queue``, and the reverse.
- The broker: a round trip, one frame per request landing as one worker
  batch at deadline 0, JSON rows stacked into one array, the ring size
  (``RAFIKI_SHM_RING_BYTES``, default 1 MiB: one 224x224x3 f32 image fits,
  eight are refused with ``FrameTooLargeError`` as in the JAX package, and
  413 at the admin door).
- No fallback: a ring the shm filesystem cannot hold raises
  ``ShmNoSpaceError`` when it is created, and a library that cannot be
  built (no ``g++``) raises ``NativeBuildError`` from the broker and from
  ``make_broker`` under ``RAFIKI_BROKER=shm``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import rafiki_tpu_torch
from rafiki_tpu.cache.shm_broker import ShmBroker as JaxShmBroker
from rafiki_tpu.cache.queue import FrameTooLargeError as JaxFrameTooLarge
from rafiki_tpu.native import shm_queue as jshm
from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import shm_broker
from rafiki_tpu_torch.cache.queue import FrameTooLargeError
from rafiki_tpu_torch.cache.shm_broker import (
    ShmBroker,
    ShmBrokerClient,
    make_broker,
)
from rafiki_tpu_torch.native import build
from rafiki_tpu_torch.native.shm_queue import (
    ShmMessageQueue,
    ShmNoSpaceError,
    ShmQueueClosed,
    make_queue_name,
)

ROOT = Path(rafiki_tpu_torch.__file__).resolve().parents[1]
IMAGE = (224, 224, 3)  # one ViT-B/16 query: 602,112 bytes of f32


@pytest.fixture()
def ring():
    queues = []

    def make(capacity=1 << 14, name=None):
        q = ShmMessageQueue(name or make_queue_name("tt"), capacity=capacity)
        queues.append(q)
        return q

    yield make
    for q in queues:
        q.close()
        q.destroy()


# ---------------------------------------------------------------------------
# the native queue
# ---------------------------------------------------------------------------

def test_fifo_and_timeout(ring):
    q = ring()
    for i in range(10):
        q.push(f"msg{i}".encode())
    assert [q.pop() for _ in range(10)] == [f"msg{i}".encode()
                                            for i in range(10)]
    t0 = time.monotonic()
    assert q.pop(timeout_s=0.05) is None
    assert time.monotonic() - t0 >= 0.04
    # a full ring times out a push
    big = ring(capacity=1 << 12)
    big.push(b"x" * 3000)
    with pytest.raises(TimeoutError):
        big.push(b"y" * 3000, timeout_s=0.05)


def test_wraparound_and_large_messages(ring):
    """Messages that straddle the ring's end wrap; one larger than the 64
    KiB receive buffer grows it; one larger than the ring is refused."""
    q = ring(capacity=1 << 17)
    rng = np.random.default_rng(0)
    for i in range(40):
        payload = rng.bytes(int(rng.integers(1, 90_000)))
        q.push(payload)
        assert q.pop(timeout_s=1.0) == payload, i
    assert q.stats()["used_bytes"] == 0
    assert q.stats()["used_bytes_hw"] >= 80_000
    with pytest.raises(ValueError, match="exceeds the ring capacity"):
        q.push(b"z" * (1 << 17))


def test_close_drains_then_raises(ring):
    q = ring()
    q.push(b"last")
    q.close()
    with pytest.raises(ShmQueueClosed):
        q.push(b"more")
    assert q.pop() == b"last"
    with pytest.raises(ShmQueueClosed):
        q.pop(timeout_s=0.05)


_CHILD = """
import sys
from rafiki_tpu_torch.native.shm_queue import ShmMessageQueue
req = ShmMessageQueue(sys.argv[1], create=False)
resp = ShmMessageQueue(sys.argv[2], create=False)
msg = req.pop(timeout_s=30.0)
resp.push(b"echo:" + msg)
req.destroy()
resp.destroy()
"""


def test_cross_process_attach(ring):
    req, resp = ring(), ring()
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, req.name,
                             resp.name], cwd=ROOT)
    try:
        req.push(b"ping")
        assert resp.pop(timeout_s=60.0) == b"echo:ping"
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.parametrize("owner", ["torch", "jax"])
def test_rings_attach_across_packages(owner):
    """The ring protocol is byte-compatible: either package creates, the
    other attaches; messages go both ways, wrapping and growing."""
    name = make_queue_name("xpkg")
    if owner == "torch":
        made = ShmMessageQueue(name, capacity=1 << 16)
        other = jshm.ShmMessageQueue(name, create=False)
    else:
        made = jshm.ShmMessageQueue(name, capacity=1 << 16)
        other = ShmMessageQueue(name, create=False)
    try:
        rng = np.random.default_rng(1)
        for i in range(30):
            payload = rng.bytes(int(rng.integers(1, 40_000)))
            src, dst = (made, other) if i % 2 else (other, made)
            src.push(payload)
            assert dst.pop(timeout_s=1.0) == payload
        made.close()
        with pytest.raises((ShmQueueClosed, jshm.ShmQueueClosed)):
            other.push(b"after close")
    finally:
        other.destroy()
        made.destroy()


# ---------------------------------------------------------------------------
# the broker
# ---------------------------------------------------------------------------

@pytest.fixture()
def broker():
    b = ShmBroker()
    yield b
    b.close()
    assert not list(Path("/dev/shm").glob(f"{b.prefix}-*"))


def _serve(wq, answer, rounds=100):
    def loop():
        for _ in range(rounds):
            batch = wq.take_batch(max_size=64, deadline_s=0.0,
                                  wait_timeout_s=0.1)
            if batch is None:
                return
            for handle, query in batch:
                handle.set_result(answer(query))

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def test_broker_round_trip(broker):
    wq = broker.register_worker("job1", "w1")
    worker = _serve(wq, lambda q: {"echo": q})
    proxies = broker.get_worker_queues("job1")
    assert list(proxies) == ["w1"]
    futs = [f for i in range(20)
            for f in proxies["w1"].submit_many([{"n": i}])]
    assert [f.result(timeout=10.0) for f in futs] == [
        {"echo": {"n": i}} for i in range(20)]
    assert proxies["w1"].depth() == 0
    broker.unregister_worker("job1", "w1")
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_a_worker_process_attaches_through_the_client(broker):
    """The owner creates the rings; ``ShmBrokerClient`` attaches by name
    (as a worker process does) and detaches without closing them."""
    broker.register_worker("job2", "w2")
    client = ShmBrokerClient(broker.prefix, attach_timeout_s=2.0)
    wq = client.register_worker("job2", "w2")
    worker = _serve(wq, lambda q: q * 2, rounds=20)
    futs = broker.get_worker_queues("job2")["w2"].submit_many(
        [np.float32(1.5), np.float32(2.0)])
    assert [float(f.result(timeout=10.0)) for f in futs] == [3.0, 4.0]
    worker.join(timeout=10)
    client.unregister_worker("job2", "w2")
    # the owner's ring is still open for a restarted worker
    assert broker.get_worker_queues("job2")["w2"].submit_many([1.0])
    with pytest.raises(OSError):
        ShmBrokerClient(broker.prefix, attach_timeout_s=0.1).register_worker(
            "job2", "no-such-worker")


@pytest.mark.parametrize("queries", [
    [{"n": i} for i in range(5)],
    [np.full(IMAGE[:1], i, np.float32) for i in range(5)],
    [[float(i)] * 4 for i in range(5)],
], ids=["json", "arrays", "json-rows"])
def test_one_request_is_one_frame_and_one_batch(broker, queries):
    """A request crosses the ring as one frame and lands as one worker
    batch, even at deadline 0; arrays and JSON rows of floats travel
    stacked, as one (n, ...) array."""
    wq = broker.register_worker("job1", "w1")
    proxy = broker.get_worker_queues("job1")["w1"]
    futs = proxy.submit_many(queries)
    assert proxy.depth() == 5
    raw = wq._qq.pop(timeout_s=1.0)
    assert wq._qq.pop(timeout_s=0.05) is None  # one message for 5 queries
    entries, binary, trace_meta = shm_broker._decode_query_frame(raw)
    assert binary and len(entries) == 5 and trace_meta is None
    if not isinstance(queries[0], dict):
        assert "qarr" in shm_broker.wire.decode(raw)
    wq._qq.push(raw)
    batch = wq.take_batch(max_size=64, deadline_s=0.0, wait_timeout_s=1.0)
    assert len(batch) == 5
    for (handle, query), sent in zip(batch, queries):
        assert np.array_equal(np.asarray(query), np.asarray(sent)) \
            if not isinstance(sent, dict) else query == sent
        handle.set_result("ok")
    assert [f.result(timeout=5.0) for f in futs] == ["ok"] * 5
    assert proxy.depth() == 0


@pytest.mark.parametrize("message", [
    {"id": "q0", "query": [1.0, 2.0]},
    {"ids": ["q0", "q1"], "queries": [[1.0, 2.0], [3.0]], "deadline": None},
], ids=["per-query", "batched"])
def test_json_messages_are_served_and_answered_in_json(broker, message):
    """A JAX-package submitter under RAFIKI_WIRE_BINARY=0 sends JSON (one
    message a query, or one for the request): the worker serves it and
    answers in JSON, which the listener resolves."""
    from rafiki_tpu_torch.cache.queue import QueryFuture

    wq = broker.register_worker("job1", "w1")
    ids = [message["id"]] if "id" in message else message["ids"]
    futs = [QueryFuture() for _ in ids]
    broker._reserve_capacity("job1", "w1", len(ids))
    for qid, fut in zip(ids, futs):
        broker._register_pending("job1", "w1", qid, fut, None)
    wq._qq.push(json.dumps(message).encode())
    batch = wq.take_batch(max_size=64, deadline_s=0.0, wait_timeout_s=1.0)
    assert [q for _, q in batch] == (
        [message["query"]] if "id" in message else message["queries"])
    for handle, query in batch:
        handle.set_result(sum(query))
    assert [f.result(timeout=5.0) for f in futs] == [
        sum(q) for _, q in batch]


def test_a_corrupt_frame_is_dropped_and_the_worker_goes_on(broker):
    wq = broker.register_worker("job1", "w1")
    wq._qq.push(b"\xabRWF\x01\x00garbage")
    assert wq.take_batch(max_size=8, deadline_s=0.0, wait_timeout_s=1.0) == []
    assert wq.stats()["wire_errors"] == 1
    futs = broker.get_worker_queues("job1")["w1"].submit_many([1.0])
    (handle, query), = wq.take_batch(max_size=8, deadline_s=0.0,
                                     wait_timeout_s=1.0)
    handle.set_result(query * 2)
    assert futs[0].result(timeout=5.0) == 2.0


def test_the_depth_cap_refuses_a_request_whole(broker, monkeypatch):
    from rafiki_tpu_torch.cache.queue import QueueFullError

    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "4")
    broker.register_worker("job1", "w1")
    proxy = broker.get_worker_queues("job1")["w1"]
    proxy.submit_many([1.0, 2.0, 3.0])
    with pytest.raises(QueueFullError):
        proxy.submit_many([4.0, 5.0])
    assert proxy.depth() == 3 and broker.stats()["rejected"] == 2


def _frame_too_large(make_broker_fn, n):
    b = make_broker_fn()
    try:
        b.register_worker("job", "w")
        proxy = b.get_worker_queues("job")["w"]
        images = [np.zeros(IMAGE, np.float32) for _ in range(n)]
        try:
            proxy.submit_many(images)
        except (FrameTooLargeError, JaxFrameTooLarge):
            return True
        return False
    finally:
        b.close()


@pytest.mark.parametrize("n,refused", [(1, False), (8, True)])
def test_the_default_ring_fits_one_image_not_eight(monkeypatch, n, refused):
    """At the default 1 MiB ring a 224x224x3 f32 image (602,112 bytes)
    fits and eight (4.8 MB) are refused with FrameTooLargeError, as in the
    JAX package."""
    monkeypatch.delenv("RAFIKI_SHM_RING_BYTES", raising=False)
    assert config.SHM_RING_BYTES == 1 << 20
    assert _frame_too_large(ShmBroker, n) is refused
    assert _frame_too_large(JaxShmBroker, n) is refused


def test_the_ring_size_setting_is_honoured(monkeypatch):
    monkeypatch.setenv("RAFIKI_SHM_RING_BYTES", str(8 << 20))
    q = ShmMessageQueue(make_queue_name("size"))
    try:
        assert q.capacity == 8 << 20
        assert os.path.getsize(f"/dev/shm/{q.name[1:]}") > 8 << 20
    finally:
        q.destroy()
    assert not _frame_too_large(ShmBroker, 8)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

_SMALL_SHM = """
import errno, sys
from rafiki_tpu_torch.native.shm_queue import ShmMessageQueue, ShmNoSpaceError
try:
    ShmMessageQueue("/nospace-test", capacity=4 << 20)
except ShmNoSpaceError as e:
    assert e.errno == errno.ENOSPC, e.errno
    print("typed:", e)
    sys.exit(0)
sys.exit("a 4 MiB ring was created on a 1 MiB tmpfs")
"""


def test_a_ring_larger_than_the_shm_filesystem_is_refused_typed():
    """The ring is reserved when it is created: on a 1 MiB tmpfs a 4 MiB
    ring raises ShmNoSpaceError (ENOSPC) at once, where the original's
    ftruncate succeeded and the first write past the limit was a SIGBUS.
    The small tmpfs is mounted over /dev/shm in a private mount
    namespace."""
    build.build_library("shmqueue")  # built outside the namespace
    unshare = shutil.which("unshare")
    assert unshare, "unshare(1) is needed to mount a small tmpfs"
    script = ("mount -t tmpfs -o size=1m tmpfs /dev/shm && exec "
              f"{sys.executable} -c '{_SMALL_SHM}'")
    proc = subprocess.run([unshare, "-rm", "sh", "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "typed:" in proc.stdout and "RAFIKI_SHM_RING_BYTES" in proc.stdout


def test_a_missing_compiler_raises_instead_of_falling_back(
        monkeypatch, tmp_path):
    from rafiki_tpu_torch.native import shm_queue

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setenv("PATH", "")
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ not found"):
        shm_queue.library()
    with pytest.raises(build.NativeBuildError):
        ShmBroker()
    monkeypatch.setenv("RAFIKI_BROKER", "shm")
    with pytest.raises(build.NativeBuildError):
        make_broker()
    assert not (tmp_path / "native").exists() or not list(
        (tmp_path / "native").iterdir())


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(build.NativeBuildError, match="broken.cpp"):
        build.load_library("broken")
    assert not list((tmp_path / "out").glob("*"))


#: a template whose model answers [0.5, 0.5] to any query
ECHO_TEMPLATE = b'''
from rafiki_tpu_torch.sdk.knob import FixedKnob
from rafiki_tpu_torch.sdk.model import BaseModel


class Echo(BaseModel):
    @staticmethod
    def get_knob_config():
        return {"k": FixedKnob(1)}

    def train(self, dataset_uri):
        pass

    def evaluate(self, dataset_uri):
        return 0.5

    def predict(self, queries):
        return [[0.5, 0.5] for _ in queries]

    def dump_parameters(self):
        return {"w": [1.0]}

    def load_parameters(self, params):
        pass
'''


def test_an_oversized_request_is_413_at_the_admin_door(tmp_path,
                                                       monkeypatch):
    """Thread placement with RAFIKI_BROKER=shm serves through the rings;
    a JSON request of eight 224x224x3 images (its rows travel as one
    float64 array, 9.6 MB) does not fit the default 1 MiB ring: 413, not
    the retryable 429."""
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client, RafikiError
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.manager import (
        ChipAllocator,
        LocalPlacementManager,
    )

    monkeypatch.setenv("RAFIKI_BROKER", "shm")
    monkeypatch.delenv("RAFIKI_SHM_RING_BYTES", raising=False)
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    assert isinstance(admin.broker, ShmBroker)
    srv = AdminServer(admin).start()
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=120)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("echo", "IMAGE_CLASSIFICATION", ECHO_TEMPLATE, "Echo")
        c.create_train_job("echo", "IMAGE_CLASSIFICATION", "t", "e",
                           budget={"MODEL_TRIAL_COUNT": 1})
        assert c.wait_until_train_job_stopped(
            "echo", timeout_s=60)["status"] == "STOPPED"
        c.create_inference_job("echo")
        assert c.predict("echo", [[0.1, 0.2]] * 3) == [[0.5, 0.5]] * 3
        images = np.zeros((8,) + IMAGE, np.float32).tolist()
        with pytest.raises(RafikiError) as err:
            c.predict("echo", images)
        assert err.value.status == 413
        assert "RAFIKI_SHM_RING_BYTES" in str(err.value)
        c.stop_inference_job("echo")
    finally:
        srv.stop()
        admin.shutdown()
    assert not list(Path("/dev/shm").glob(f"{admin.broker.prefix}-*"))
