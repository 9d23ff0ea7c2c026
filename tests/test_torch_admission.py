"""Admission at the serving doors: ``rafiki_tpu_torch/predictor/admission.py``
against ``rafiki_tpu/predictor/admission.py``, and the port's two doors.

- the same script of ``admit``/``observe``/``release``/``note_backend_shed``
  through both controllers gives the same sheds (kind and
  ``retry_after_s``) and equal ``stats()``;
- a new controller's EWMA starts from its door's median latency (the
  port's small record standing in for JAX's registry histogram);
- ``/generate``'s cost in KV blocks equals the JAX door's;
- the per-job door (after ``tests/test_overload_http.py``): a stalled
  fleet sheds 429 + ``Retry-After`` fast while the admitted requests
  answer; ``/healthz`` has the JAX door's shape; ``stop()`` drains, is
  bounded and idempotent; concurrent clients shed cleanly; a burst past
  the in-flight cap sheds 503 with the counts adding up;
- the admin's ``/predict/<app>``: 503 at its cap and 429 + ``Retry-After``
  on an unmeetable deadline, mapped as the JAX admin maps them.

A stalled worker here is a thread serving a bounded queue slowly (the
port's worker chaos site is not hooked).
"""

import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

from rafiki_tpu.predictor import admission as jadm
from rafiki_tpu.predictor import server as jserver
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.cache.queue import InProcessBroker, QueueFullError
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.predictor import admission as tadm
from rafiki_tpu_torch.predictor import server as tserver
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.server import PredictorServer

from test_torch_stack import FAKE_TEMPLATE


def _door():
    return f"t-{uuid.uuid4().hex[:12]}"


def _run_script(mod, script, **kw):
    """Each step's outcome (None, or the shed's type name and
    retry_after_s) and the final stats."""
    adm = mod.AdmissionController(door=_door(), **kw)
    out = []
    for op, *args in script:
        if op == "admit":
            try:
                adm.admit(*args)
                out.append(None)
            except RuntimeError as e:
                out.append((type(e).__name__, e.retry_after_s))
        else:
            getattr(adm, op)(*args)
    return out, adm.stats()


SCRIPTS = {
    "cap": ([("admit", 10.0), ("admit", 10.0), ("admit", 10.0),
             ("release",), ("admit", 10.0), ("admit", 10.0)],
            {"max_inflight": 2}),
    "deadline": ([("admit", 0.001, 10_000), ("release",),
                  ("observe", 1.0, 1), ("admit", 2.0, 5), ("admit", 10.0, 5),
                  ("observe", 0.5, 4), ("admit", 0.5, 8), ("admit", 0.5, 0),
                  ("release",), ("release",)],
                 {"max_inflight": 0}),
    "mixed": ([("admit", 5.0, 3, "appA", 4), ("observe", 0.4, 4),
               ("admit", 0.1, 3, "appA"), ("admit", 5.0, 2, "appB", 2),
               ("admit", 5.0), ("note_backend_shed",), ("release", "appA"),
               ("admit", 5.0, 1), ("observe", 2.0, 1),
               ("admit", 0.5, 1), ("release",), ("release",)],
              {"max_inflight": 2, "shared_tenants": True}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_same_script_sheds_alike_in_both_packages(name):
    script, kw = SCRIPTS[name]
    theirs = _run_script(jadm, script, **kw)
    ours = _run_script(tadm, script, **kw)
    assert ours == theirs
    assert any(o is not None for o in ours[0])


def test_the_cap_is_read_at_each_admit(monkeypatch):
    adm = tadm.AdmissionController(door=_door())
    monkeypatch.setenv("RAFIKI_PREDICT_MAX_INFLIGHT", "1")
    adm.admit(1.0)
    with pytest.raises(tadm.ServerOverloadedError):
        adm.admit(1.0)
    monkeypatch.setenv("RAFIKI_PREDICT_MAX_INFLIGHT", "0")  # no cap
    adm.admit(1.0)
    assert adm.stats()["max_inflight"] == 0


def test_retry_after_headers_match():
    for e in (tadm.ServerOverloadedError("x", 0.2),
              tadm.DeadlineUnmeetableError("x", 7.2),
              QueueFullError("x", 3.0)):
        assert tadm.retry_after_headers(e) == jadm.retry_after_headers(e)
    assert issubclass(tadm.TenantOverShareError,
                      tadm.DeadlineUnmeetableError)


def test_a_new_controller_starts_from_its_doors_median():
    """A rebuilt door is not blind under a flood: its EWMA starts at the
    median of the door's recent latencies, as JAX's starts from its
    registry histogram; a door with no history starts at 0 in both."""
    door = _door()
    assert tadm.AdmissionController(door=door).stats()["ewma_query_s"] == 0
    assert jadm.AdmissionController(door=door).stats()["ewma_query_s"] == 0
    first = tadm.AdmissionController(door=door)
    jfirst = jadm.AdmissionController(door=door)
    for latency in (0.1, 0.3, 0.2, 0.5, 0.4):
        first.observe(latency, 4)
        jfirst.observe(latency, 4)
    assert tadm.door_median_latency(door) == pytest.approx(0.3)
    seeded = tadm.AdmissionController(door=door)
    assert seeded.stats()["ewma_query_s"] == pytest.approx(0.3)
    jseeded = jadm.AdmissionController(door=door)
    # JAX's bucketed histogram quantile: the same seed within its bucket
    assert 0.1 <= jseeded.stats()["ewma_query_s"] <= 0.5
    # the seed sheds where a blind controller would admit
    with pytest.raises(tadm.DeadlineUnmeetableError):
        seeded.admit(1.0, backlog_depth=10)
    tadm.AdmissionController(door=_door()).admit(1.0, backlog_depth=10)


@pytest.mark.parametrize("paged", ["1", "0"])
@pytest.mark.parametrize("block", ["16", "7"])
def test_generate_cost_in_kv_blocks_matches(monkeypatch, paged, block):
    monkeypatch.setenv("RAFIKI_GEN_KV_PAGED", paged)
    monkeypatch.setenv("RAFIKI_GEN_KV_BLOCK_TOKENS", block)
    for prompt, budget in [(0, 0), (1, 1), (15, 1), (16, 16), (100, 64),
                           (513, 0), (0, 300)]:
        assert (tserver._generate_cost(prompt, budget)
                == jserver._generate_cost(prompt, budget))


# -- the per-job door ----------------------------------------------------------


def _post(url, body, token=None, timeout=30, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers), \
                time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers), \
            time.monotonic() - t0


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


class _SlowServer:
    """Serves a worker queue: each batch waits ``stall_s``, then answers
    ``[1.0, 0.0]`` a query."""

    def __init__(self, queue, stall_s):
        self.queue, self.stall_s = queue, stall_s
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            batch = self.queue.take_batch(max_size=16, deadline_s=0.0)
            if batch is None:
                return
            if batch and self.stall_s:
                time.sleep(self.stall_s)
            for fut, _ in batch:
                fut.set_result([1.0, 0.0])


def _stalled_door(n_replicas, stall_s, app):
    broker = InProcessBroker()
    job = f"job-{app}"
    queues = [broker.register_worker(job, f"w{i}")
              for i in range(n_replicas)]
    for q in queues:
        _SlowServer(q, stall_s)
    predictor = Predictor(job, broker, "IMAGE_CLASSIFICATION",
                          worker_trials={f"w{i}": "trialA"
                                         for i in range(n_replicas)})
    server = PredictorServer(predictor, app, auth=False).start()
    return broker, job, server, f"http://{server.host}:{server.port}"


def test_a_stalled_fleet_sheds_429_fast_and_the_admitted_answer(
        monkeypatch):
    """The JAX drill through the port's door: 2 stalled replicas with
    queues of 1 hold 4 requests (1 serving + 1 queued each); the fifth is
    shed with 429 + Retry-After at once, and the 4 are answered."""
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "1")
    broker, job, server, url = _stalled_door(2, 1.5, "ovl")
    try:
        results = []

        def fire():
            results.append(_post(url + "/predict", {"queries": [[0.0]]})[0])

        threads = [threading.Thread(target=fire) for _ in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.15)
        status, payload, headers, secs = _post(url + "/predict",
                                               {"queries": [[0.0]]})
        assert status == 429, payload
        assert int(headers["Retry-After"]) >= 1
        assert secs < 0.5
        for t in threads:
            t.join(timeout=10)
        assert results == [200] * 4
        health = _get(url + "/healthz")[1]
        assert health["overload"]["requests_shed"] == 1
        assert health["admission"]["admitted"] == 5
    finally:
        server.stop(drain_timeout_s=0.0)
        for wid in ("w0", "w1"):
            broker.unregister_worker(job, wid)


def test_healthz_has_the_jax_doors_shape():
    """Degraded with no worker queue, ok with one; the admission and
    overload sections carry the JAX door's keys."""
    from rafiki_tpu.cache.queue import InProcessBroker as JaxBroker
    from rafiki_tpu.predictor.predictor import Predictor as JaxPredictor

    ours = PredictorServer(Predictor("nojob", InProcessBroker(), None),
                           "emptyapp", auth=False).start()
    theirs = jserver.PredictorServer(JaxPredictor("nojob", JaxBroker(), None),
                                     "emptyapp", auth=False).start()
    try:
        _, mine = _get(f"http://{ours.host}:{ours.port}/healthz")
        _, ref = _get(f"http://{theirs.host}:{theirs.port}/healthz")
        assert mine["status"] == ref["status"] == "degraded"
        assert mine["workers"] == ref["workers"] == 0
        assert set(mine["admission"]) == set(ref["admission"])
        assert mine["overload"] == ref["overload"]
        assert set(mine) <= set(ref) | {"overload"}
    finally:
        ours.stop()
        theirs.stop()
    broker = InProcessBroker()
    broker.register_worker("job", "w1")
    live = PredictorServer(Predictor("job", broker, None,
                                     worker_trials={"w1": "t"}),
                           "liveapp", auth=False).start()
    try:
        _, payload = _get(f"http://{live.host}:{live.port}/healthz")
        assert payload["status"] == "ok"
        assert payload["queue_depths"] == {"w1": 0}
    finally:
        live.stop()


class _SlowPredictor:
    """A predictor that blocks in predict (the JAX drain test's stub)."""

    def __init__(self, latency_s):
        self.latency_s = latency_s

    def predict_batch(self, queries, timeout_s=None):
        time.sleep(self.latency_s)
        return [[1.0] for _ in queries]

    def queue_depths(self):
        return {"w": 0}


def test_stop_drains_the_inflight_then_closes_and_is_idempotent():
    srv = PredictorServer(_SlowPredictor(0.6), "drainapp",
                          auth=False).start()
    url = f"http://{srv.host}:{srv.port}/predict"
    results = []
    t = threading.Thread(target=lambda: results.append(
        _post(url, {"queries": [[0.0]]}, timeout=10)[0]))
    t.start()
    time.sleep(0.2)  # the request is mid-predict
    t0 = time.monotonic()
    srv.stop(drain_timeout_s=5.0)
    drained_in = time.monotonic() - t0
    t.join(timeout=10)
    assert results == [200]
    assert 0.2 < drained_in < 5.0
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _post(url, {"queries": [[0.0]]}, timeout=2)
    srv.stop()  # a second stop does nothing


def test_the_drain_window_is_bounded():
    srv = PredictorServer(_SlowPredictor(3.0), "slowdrain",
                          auth=False).start()
    threading.Thread(target=_post, args=(
        f"http://{srv.host}:{srv.port}/predict", {"queries": [[0.0]]}),
        kwargs={"timeout": 10}, daemon=True).start()
    time.sleep(0.2)
    t0 = time.monotonic()
    srv.stop(drain_timeout_s=0.3)  # the handler needs ~3 s: the bound wins
    assert time.monotonic() - t0 < 2.0


def test_concurrent_clients_shed_cleanly(monkeypatch):
    """12 clients x 3 requests against a cap of 2 in flight and queues of
    4: every answer is 200, 429 or 503 (never a reset or a 500), some are
    200, and the door serves afterwards."""
    monkeypatch.setenv("RAFIKI_PREDICT_MAX_INFLIGHT", "2")
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "4")
    broker, job, server, url = _stalled_door(1, 0.05, "stress")
    try:
        codes = []
        lock = threading.Lock()

        def client():
            for _ in range(3):
                status = _post(url + "/predict", {"queries": [[0.0]]})[0]
                with lock:
                    codes.append(status)

        threads = [threading.Thread(target=client) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(codes) == 36
        assert set(codes) <= {200, 429, 503}, sorted(set(codes))
        assert codes.count(200) >= 1 and codes.count(503) >= 1
        stats = _get(url + "/healthz")[1]["admission"]
        assert (stats["admitted"] + stats["shed_capacity"]
                + stats["shed_deadline"]) == 36
        assert _post(url + "/predict", {"queries": [[0.0]]})[0] == 200
    finally:
        server.stop(drain_timeout_s=0.0)
        broker.unregister_worker(job, "w0")


def test_an_unmeetable_deadline_sheds_429_at_the_door(monkeypatch):
    """Backlog x EWMA past the request's timeout_s: 429 + Retry-After
    before the predictor sees it."""
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "0")
    broker, job, server, url = _stalled_door(1, 0.0, "deadline")
    try:
        assert _post(url + "/predict", {"queries": [[0.0]] * 4})[0] == 200
        # the EWMA now holds a query's time; a backlog it cannot clear
        server.predictor.backlog_depth = lambda: 10 ** 9
        status, payload, headers, _ = _post(
            url + "/predict", {"queries": [[0.0]], "timeout_s": 0.001})
        assert status == 429, payload
        assert int(headers["Retry-After"]) >= 1
        assert _get(url + "/healthz")[1]["admission"]["shed_deadline"] == 1
    finally:
        server.stop(drain_timeout_s=0.0)
        broker.unregister_worker(job, "w0")


def test_generate_is_admitted_and_a_full_fleet_is_a_booked_shed(
        monkeypatch):
    """``/generate`` takes an admission slot (counted admitted); every
    replica refusing after admission answers 429 and books the shed."""
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "1")
    broker = InProcessBroker()
    predictor = Predictor("genjob", broker, "TEXT_GENERATION")
    queue = broker.register_worker("genjob", "g0")
    queue.submit_many([{"prompt_ids": [1]}])  # full, and nobody serves
    server = PredictorServer(predictor, "genapp", auth=False).start()
    url = f"http://{server.host}:{server.port}"
    try:
        status, payload, headers, _ = _post(
            url + "/generate", {"prompt_ids": [1, 2, 3], "max_tokens": 4})
        assert status == 429, payload
        assert "Retry-After" in headers
        stats = _get(url + "/healthz")[1]["admission"]
        assert stats["admitted"] == 1 and stats["shed_deadline"] == 1
        assert stats["inflight"] == 0
    finally:
        server.stop(drain_timeout_s=0.0)


# -- the admin's door ----------------------------------------------------------


@pytest.fixture
def admin_door(tmp_path):
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    server = AdminServer(admin).start()
    auth = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                   config.SUPERADMIN_PASSWORD)
    uid = auth["user_id"]
    admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION", FAKE_TEMPLATE,
                       "FakeModel")
    admin.create_train_job(uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                           budget={"MODEL_TRIAL_COUNT": 1})
    admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
    inf = admin.create_inference_job(uid, "a")
    yield admin, f"http://127.0.0.1:{server.port}/predict/a", auth["token"], \
        admin.services.get_predictor(inf["id"])
    server.stop()
    admin.shutdown()


def test_the_admin_door_sheds_503_at_its_cap(admin_door):
    admin, url, token, predictor = admin_door
    admin._predict_admission = tadm.AdmissionController(
        max_inflight=1, door=_door(), shared_tenants=True)
    release = threading.Event()
    real = predictor.predict_batch

    def held(queries, timeout_s=None):
        release.wait(10)
        return real(queries, timeout_s)

    predictor.predict_batch = held
    first = []
    t = threading.Thread(target=lambda: first.append(
        _post(url, {"queries": [[0.0]]}, token=token)[0]))
    t.start()
    deadline = time.monotonic() + 5
    while (admin._predict_admission.stats()["inflight"] == 0
           and time.monotonic() < deadline):
        time.sleep(0.01)
    status, payload, headers, _ = _post(url, {"queries": [[0.0]]},
                                        token=token)
    release.set()
    t.join(timeout=10)
    assert status == 503, payload
    assert payload["error"].startswith("ServerOverloadedError")
    assert int(headers["Retry-After"]) >= 1
    assert first == [200]
    stats = admin._predict_admission.stats()
    assert (stats["admitted"], stats["shed_capacity"]) == (1, 1)


def test_the_admin_door_sheds_429_on_an_unmeetable_deadline(admin_door):
    admin, url, token, predictor = admin_door
    admin._predict_admission = tadm.AdmissionController(
        door=_door(), shared_tenants=True)
    assert _post(url, {"queries": [[0.0]]}, token=token)[0] == 200
    # PREDICT_TIMEOUT_S (30 s) behind a backlog the EWMA cannot clear
    predictor.backlog_depth = lambda: 10 ** 9
    status, payload, headers, _ = _post(url, {"queries": [[0.0]]},
                                        token=token)
    assert status == 429, payload
    assert payload["error"].startswith("DeadlineUnmeetableError")
    assert int(headers["Retry-After"]) >= 30
    assert admin._predict_admission.stats()["shed_deadline"] == 1


# -- weighted fair admission (RAFIKI_AUTOSCALE_FAIR) ---------------------------

#: (controller kwargs, environment, script) of each fair-admission case
FAIR_SCRIPTS = {
    # the hot tenant past its share is shed, the cold one admitted
    "hot_and_cold": (
        {"max_inflight": 4, "shared_tenants": True},
        {"RAFIKI_AUTOSCALE_FAIR_BURST": "8"},
        [("admit", 10.0), ("admit", 10.0)]
        + [("admit", 10.0, None, "hot"), ("release", "hot")] * 50
        + [("admit", 10.0, None, "cold"), ("release", "cold"),
           ("admit", 10.0, None, "hot"), ("admit", 10.0, None, "cold"),
           ("release", "cold"), ("release",), ("release",)]),
    # a weighted tenant's share is larger
    "weights": (
        {"max_inflight": 2, "shared_tenants": True},
        {"RAFIKI_AUTOSCALE_FAIR_BURST": "2",
         "RAFIKI_AUTOSCALE_FAIR_WEIGHTS": "vip=3, junk, bad=x, zero=0"},
        [("admit", 10.0)]
        + [("admit", 10.0, None, "vip"), ("release", "vip")] * 12
        + [("admit", 10.0, None, "peasant"), ("release", "peasant")] * 8
        + [("admit", 10.0, None, "vip", 3), ("release",)]),
    # no tenant holds every slot but one
    "ceiling": (
        {"max_inflight": 4, "shared_tenants": True}, {},
        [("admit", 10.0, None, "hog")] * 4
        + [("admit", 10.0, None, "newcomer"), ("release", "newcomer")]
        + [("release", "hog")] * 3 + [("admit", 10.0, None, "hog")]),
    # a door of one tenant is never rationed
    "dedicated": (
        {"max_inflight": 2}, {},
        [("admit", 10.0, None, "only"), ("admit", 10.0, None, "only", 500),
         ("release", "only"), ("release", "only")]),
    # a backend shed opens the pressure window; cost 0 charges nothing
    "pressure": (
        {"max_inflight": 64, "shared_tenants": True},
        {"RAFIKI_AUTOSCALE_FAIR_BURST": "4"},
        [("admit", 10.0, None, "a", 10), ("release", "a"),
         ("admit", 10.0, None, "b", 0), ("release", "b"),
         ("admit", 10.0, None, "b", 1), ("release", "b"),
         ("note_backend_shed",), ("admit", 10.0, None, "a", 6),
         ("admit", 10.0, None, "b", 1), ("release", "b")]),
}


@pytest.mark.parametrize("name", sorted(FAIR_SCRIPTS))
def test_fair_admission_sheds_alike_in_both_packages(name, monkeypatch):
    """The same script under ``RAFIKI_AUTOSCALE_FAIR=1`` gives the same
    sheds, stats and per-tenant charges (to 3 decimals, as
    ``fair_shares`` rounds; the decay runs on each package's clock) in
    both controllers."""
    kw, env, script = FAIR_SCRIPTS[name]
    monkeypatch.setenv("RAFIKI_AUTOSCALE_FAIR", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def run(mod):
        adm = mod.AdmissionController(door=_door(), **kw)
        out = []
        for op, *args in script:
            if op == "admit":
                try:
                    adm.admit(*args)
                    out.append(None)
                except RuntimeError as e:
                    out.append(type(e).__name__)
            else:
                getattr(adm, op)(*args)
        shares = {t: round(v) for t, v in adm.fair_shares().items()}
        return out, adm.stats(), shares

    ours = run(tadm)
    assert ours == run(jadm)
    shed = ours[1]["shed_fairness"]
    assert (shed > 0) == (name in ("hot_and_cold", "weights", "ceiling",
                                   "pressure"))
    if name == "hot_and_cold":
        assert ours[0][-3:] == [None, "TenantOverShareError", None]
        assert ours[2]["hot"] > ours[2]["cold"]


def test_fair_charges_decay_with_the_half_life(monkeypatch):
    monkeypatch.setenv("RAFIKI_AUTOSCALE_FAIR", "1")
    monkeypatch.setenv("RAFIKI_AUTOSCALE_FAIR_BURST", "2")
    monkeypatch.setenv("RAFIKI_AUTOSCALE_FAIR_WINDOW_S", "0.5")
    adm = tadm.AdmissionController(max_inflight=2, door=_door(),
                                   shared_tenants=True)
    adm.admit(10.0)  # pressure: one of two slots held
    try:
        for _ in range(12):
            adm.admit(10.0, tenant="a")
            adm.release(tenant="a")
        adm.admit(10.0, tenant="b")
        adm.release(tenant="b")
        with pytest.raises(tadm.TenantOverShareError):
            adm.admit(10.0, tenant="a")
        time.sleep(1.2)  # past two half-lives
        assert adm.fair_shares()["a"] > 2.0  # decayed only when touched
        adm.admit(10.0, tenant="b")  # the gate decays the book: b is in
        adm.release(tenant="b")
        assert adm.fair_shares()["a"] < 12 * 0.25
    finally:
        adm.release()
    # off by default: nothing is charged or shed
    monkeypatch.delenv("RAFIKI_AUTOSCALE_FAIR")
    off = tadm.AdmissionController(max_inflight=64, door=_door(),
                                   shared_tenants=True)
    for _ in range(100):
        off.admit(10.0, tenant="hog")
        off.release(tenant="hog")
    assert off.stats()["shed_fairness"] == 0 and off.fair_shares() == {}


def test_a_hot_tenant_is_shed_at_the_admin_door_and_a_cold_one_served(
        tmp_path, monkeypatch):
    """Through the admin's shared ``/predict/<app>`` door: one app floods
    past its share (its replicas stalled by the worker chaos site) and is
    shed 429 per tenant; the other app's requests are all admitted and
    answered fast."""
    from rafiki_tpu_torch.utils import chaos

    from test_torch_rollout import fake_app, job_id_of

    for k, v in (("RAFIKI_PREDICT_QUEUE_DEPTH", "2"),
                 ("RAFIKI_PREDICT_MAX_INFLIGHT", "4"),
                 ("RAFIKI_AUTOSCALE_FAIR", "1"),
                 ("RAFIKI_AUTOSCALE_FAIR_BURST", "4")):
        monkeypatch.setenv(k, v)
    admin = Admin(db=Database(str(tmp_path / "s.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = fake_app(admin, "hot")
        fake_app(admin, "cold")
        chaos.install([chaos.ChaosRule(
            site=chaos.SITE_WORKER, action=chaos.ACTION_DELAY,
            match=job_id_of(admin, uid, "hot"), delay_s=0.8)])
        stop = threading.Event()

        def hot_client():
            while not stop.is_set():
                try:
                    admin.predict(uid, "hot", [[0.0]])
                except Exception:
                    time.sleep(0.02)

        flood = [threading.Thread(target=hot_client) for _ in range(6)]
        for t in flood:
            t.start()
        time.sleep(1.0)
        lat = []
        for _ in range(5):
            t0 = time.monotonic()
            assert admin.predict(uid, "cold", [[0.0]])
            lat.append(time.monotonic() - t0)
        stop.set()
        for t in flood:
            t.join(timeout=10)
        assert max(lat) < 0.7, lat
        assert admin._predict_admission.stats()["shed_fairness"] > 0
        assert {"hot", "cold"} <= set(admin._predict_admission.fair_shares())
    finally:
        chaos.clear()
        admin.shutdown()
