"""Trial-level crash recovery of the port against the JAX package's.

The drills of ``tests/test_worker_resume.py`` through both packages'
``TrainWorker`` on the JAX fake template and its port twin, with equal
trial rows: a restarted worker re-runs the trial its predecessor left
RUNNING (same id, knobs and attempt) or terminates it when the job's
deadline has passed, leaves another worker's RUNNING trials alone,
replays completed scores (and infeasible rows) into a fresh advisor
once, and queues a feedback that failed until the advisor is back. Then
a port trial resumes from its mid-trial checkpoint on the CPU: a tiny
ViT whose first run is cut after 2 of 3 epochs ends where the
uninterrupted run ends, without re-training the checkpointed epochs.
"""

import json
import os
import threading

import numpy as np
import pytest

from rafiki_tpu.advisor.advisor import AdvisorStore as JaxStore
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.worker import train as jax_train
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.sdk.log import LogType
from rafiki_tpu_torch.worker import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FAKE = os.path.join(ROOT, "tests", "fixtures", "fake_model.py")

# the port's twin of tests/fixtures/fake_model.py: the same four knobs
PORT_FAKE = b'''
import random

from rafiki_tpu_torch.sdk.knob import (CategoricalKnob, FixedKnob, FloatKnob,
                                       IntegerKnob)
from rafiki_tpu_torch.sdk.model import BaseModel


class FakeModel(BaseModel):
    dependencies = {"numpy": None}

    @staticmethod
    def get_knob_config():
        return {
            "int_knob": IntegerKnob(1, 32),
            "float_knob": FloatKnob(1e-4, 1e-1, is_exp=True),
            "cat_knob": CategoricalKnob(["a", "b", "c"]),
            "fixed_knob": FixedKnob("fixed"),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._params = None

    def train(self, dataset_uri):
        self._params = {"weight": [1.0, 2.0]}

    def evaluate(self, dataset_uri):
        return random.random()

    def predict(self, queries):
        return [[0.5, 0.5] for _ in queries]

    def dump_parameters(self):
        return self._params

    def load_parameters(self, params):
        self._params = params
'''

KNOBS = {"int_knob": 4, "float_knob": 0.01, "cat_knob": "b",
         "fixed_knob": "fixed"}


def _seed(port: bool, budget: dict, model_bytes=None, cls="FakeModel"):
    db = Database(":memory:") if port else JaxDatabase(":memory:")
    user = db.create_user("u@x", "h", "APP_DEVELOPER")
    if model_bytes is None:
        with open(JAX_FAKE, "rb") as f:
            model_bytes = PORT_FAKE if port else f.read()
    model = db.create_model(user["id"], "fake", "IMAGE_CLASSIFICATION",
                            model_bytes, cls, {"numpy": None}, "PUBLIC")
    job = db.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                              "uri://t", "uri://e", budget)
    sub = db.create_sub_train_job(job["id"], model["id"])
    return db, job, sub, model


def _start(port: bool, db, sub_id, store, service_id, params_dir,
           chips=None):
    if port:
        ctx = ServiceContext(service_id=service_id, chips=chips or ["cpu"],
                             stop_event=threading.Event(),
                             service_type="TRAIN")
        worker = train.TrainWorker(sub_id, db, store, params_dir=params_dir)
    else:
        ctx = jax_manager.ServiceContext(
            service_id=service_id, service_type="TRAIN", chips=[],
            stop_event=threading.Event())
        worker = jax_train.TrainWorker(sub_id, db, store,
                                       params_dir=params_dir)
    worker.start(ctx)
    return worker


def _rows(db, sub_id):
    trials = sorted(db.get_trials_of_sub_train_job(sub_id),
                    key=lambda t: t["datetime_started"])
    return [(t["status"], t["attempt"], t["worker_id"]) for t in trials]


@pytest.mark.parametrize("attempt", [0, 1])
def test_a_stale_running_trial_resumes_under_its_id(tmp_path, attempt):
    out = []
    for port in (True, False):
        db, job, sub, model = _seed(port, {"MODEL_TRIAL_COUNT": 3})
        stale = db.create_trial(sub["id"], model["id"], KNOBS,
                                worker_id="svc-resume")
        if attempt:  # the predecessor had already absorbed a fault
            db.record_trial_fault(stale["id"], "INFRA", "absorbed")
        _start(port, db, sub["id"], AdvisorStore() if port else JaxStore(),
               "svc-resume", str(tmp_path / str(port)))
        resumed = db.get_trial(stale["id"])
        assert resumed["status"] == "COMPLETED"
        assert resumed["knobs"] == KNOBS
        assert os.path.exists(resumed["params_file_path"])
        out.append((_rows(db, sub["id"]), resumed["attempt"],
                    resumed["fault_kind"]))
        db.close()
    assert out[0] == out[1]
    assert out[0][0] == [("COMPLETED", attempt, "svc-resume")] + [
        ("COMPLETED", 0, "svc-resume")] * 2


def test_a_stale_trial_past_the_deadline_is_terminated(tmp_path):
    out = []
    for port in (True, False):
        db, job, sub, model = _seed(port, {"MODEL_TRIAL_COUNT": 3,
                                           "TIME_HOURS": 0})
        stale = db.create_trial(sub["id"], model["id"], KNOBS,
                                worker_id="svc-late")
        ckpt = tmp_path / str(port) / f"{stale['id']}.ckpt"
        ckpt.parent.mkdir(parents=True)
        ckpt.write_bytes(b"epochs")
        stray = ckpt.parent / f"{stale['id']}.ckpt.abc123.tmp"
        stray.write_bytes(b"a write a kill cut short")
        events = []
        worker_cls = train.TrainWorker if port else jax_train.TrainWorker
        ctx = (ServiceContext(service_id="svc-late", chips=["cpu"])
               if port else jax_manager.ServiceContext(
                   service_id="svc-late", service_type="TRAIN", chips=[],
                   stop_event=threading.Event()))
        worker_cls(sub["id"], db, AdvisorStore() if port else JaxStore(),
                   send_event=lambda n, p: events.append(n),
                   params_dir=str(ckpt.parent)).start(ctx)
        assert not ckpt.exists()
        if port:  # the port also sweeps the interrupted write's tmp file
            assert not stray.exists()
        out.append((_rows(db, sub["id"]), events))
        db.close()
    assert out[0] == out[1] == ([("TERMINATED", 0, "svc-late")],
                                [train.EVENT_BUDGET_REACHED])


def test_another_workers_running_trials_are_left_alone(tmp_path):
    out = []
    for port in (True, False):
        db, job, sub, model = _seed(port, {"MODEL_TRIAL_COUNT": 2})
        other = db.create_trial(sub["id"], model["id"],
                                {"fixed_knob": "fixed"},
                                worker_id="someone-else")
        _start(port, db, sub["id"], AdvisorStore() if port else JaxStore(),
               "svc-b", str(tmp_path / str(port)))
        assert db.get_trial(other["id"])["status"] == "RUNNING"
        out.append(_rows(db, sub["id"]))
        db.close()
    assert out[0] == out[1] == [("RUNNING", 0, "someone-else"),
                                ("COMPLETED", 0, "svc-b")]


def test_completed_and_infeasible_rows_are_replayed_once(tmp_path):
    states = []
    for port in (True, False):
        db, job, sub, model = _seed(port, {"MODEL_TRIAL_COUNT": 5})
        for score in (0.3, 0.8):
            t = db.create_trial(sub["id"], model["id"],
                                {**KNOBS, "cat_knob": "a"})
            db.mark_trial_as_complete(t["id"], score, None)
        t = db.create_trial(sub["id"], model["id"],
                            {**KNOBS, "int_knob": 30, "float_knob": 0.09})
        db.mark_trial_as_errored(t["id"], "USER", "boom")
        store = AdvisorStore() if port else JaxStore()
        _start(port, db, sub["id"], store, "svc-r2",
               str(tmp_path / str(port)))
        advisor = store.get(sub["id"])
        # 2 replayed + 2 newly run; the USER row replayed as infeasible
        states.append((len(advisor.history), advisor.infeasible_count,
                       store.replay_feedback(sub["id"], [(KNOBS, 0.5)])))
        db.close()
    assert states[0] == states[1] == (4, 1, False)


class _FlakyAdvisor:
    def __init__(self):
        self.fail = True
        self.seen = []

    def feedback(self, knobs, score):
        if self.fail:
            raise ConnectionError("advisor briefly down")
        self.seen.append((knobs, score))


class _Store:
    def __init__(self):
        self.advisor = _FlakyAdvisor()

    def get(self, advisor_id):
        return self.advisor


def test_a_failed_feedback_is_queued_and_retried():
    out = []
    for cls in (train.TrainWorker, jax_train.TrainWorker):
        w = cls("sub", db=None, advisor_store=_Store())
        w._feedback_best_effort("a", {"k": 1}, 0.5)  # fails: queued
        queued = list(w._pending_feedback)
        w._advisors.advisor.fail = False
        w._feedback_best_effort("a", {"k": 2}, 0.7)  # flushes the queue first
        out.append((queued, w._pending_feedback, w._advisors.advisor.seen))
    assert out[0] == out[1] == ([({"k": 1}, 0.5)], [],
                                [({"k": 1}, 0.5), ({"k": 2}, 0.7)])


# -- a trial resumes from its checkpoint ----------------------------------------

TINY_VIT = (b'''
from rafiki_tpu_torch.sdk.knob import FixedKnob
from rafiki_tpu_torch.templates.torch_vit import TorchViT


class TinyViT(TorchViT):
    """TorchViT at test width, three epochs."""

    @staticmethod
    def get_knob_config():
        return {"image_size": FixedKnob(16), "patch_size": FixedKnob(8),
                "dim": FixedKnob(32), "depth": FixedKnob(2),
                "heads": FixedKnob(2), "num_classes": FixedKnob(4),
                "learning_rate": FixedKnob(1e-3), "batch_size": FixedKnob(8),
                "epochs": FixedKnob(3)}
''')


def _epochs_logged(db, trial_id):
    return [r["metrics"]["epoch"] for r in map(json.loads,
                                                db.get_trial_logs(trial_id))
            if r["type"] == LogType.METRICS and "loss" in r["metrics"]]


def test_a_killed_trial_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """The first worker is cut after epoch 2 of 3 (its checkpoint written,
    the trial left RUNNING, as a SIGKILL leaves it); the restarted worker
    re-runs the trial under its id, trains only epoch 3 from the
    checkpoint, and ends with the parameters of an uninterrupted run."""
    from rafiki_tpu_torch.sdk import torch_backend
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.params import flatten, load_params

    rng = np.random.default_rng(0)
    uris = {}
    for split, n in (("train", 32), ("test", 16)):
        x = rng.random((n, 16, 16, 3), dtype=np.float32)
        y = rng.integers(0, 4, n).astype(np.int32)
        uris[split] = write_numpy_dataset(x, y, str(tmp_path / f"{split}.npz"))

    class Killed(BaseException):
        """Not an Exception: the worker's handlers let it through, as a
        SIGKILL would end the process mid-trial."""

    def run(kill_after_epoch):
        db = Database(":memory:")
        user = db.create_user("u@x", "h", "APP_DEVELOPER")
        model = db.create_model(user["id"], "vit", "IMAGE_CLASSIFICATION",
                                TINY_VIT, "TinyViT", {}, "PRIVATE")
        job = db.create_train_job(user["id"], "a", 1, "IMAGE_CLASSIFICATION",
                                  uris["train"], uris["test"],
                                  {"MODEL_TRIAL_COUNT": 1})
        sub = db.create_sub_train_job(job["id"], model["id"])
        params = tmp_path / f"params-{kill_after_epoch}"
        save = torch_backend.DataParallelTrainer._save_checkpoint

        def save_then_die(path, model, opt, next_epoch, state=None):
            save(path, model, opt, next_epoch, state)
            if next_epoch == kill_after_epoch:
                raise Killed()

        with monkeypatch.context() as m:
            m.setattr(torch_backend.DataParallelTrainer, "_save_checkpoint",
                      staticmethod(save_then_die))
            try:
                _start(True, db, sub["id"], AdvisorStore(), "svc",
                       str(params))
            except Killed:
                pass
        (trial,) = db.get_trials_of_sub_train_job(sub["id"])
        return db, sub, trial, params

    db, sub, cut, params = run(kill_after_epoch=2)
    assert cut["status"] == "RUNNING"
    assert (params / f"{cut['id']}.ckpt").exists()
    assert _epochs_logged(db, cut["id"]) == [0.0, 1.0]
    _start(True, db, sub["id"], AdvisorStore(), "svc", str(params))
    (done,) = db.get_trials_of_sub_train_job(sub["id"])
    assert (done["id"], done["status"], done["knobs"]) == (
        cut["id"], "COMPLETED", cut["knobs"])
    assert _epochs_logged(db, cut["id"]) == [0.0, 1.0, 2.0]  # epoch 3 once
    assert not list(params.glob("*.ckpt*"))
    ref_db, _, ref, _ = run(kill_after_epoch=0)
    assert ref["status"] == "COMPLETED"
    resumed = flatten(load_params(read_artifact(done["params_file_path"])))
    straight = flatten(load_params(read_artifact(ref["params_file_path"])))
    assert resumed.keys() == straight.keys()
    for k in straight:
        np.testing.assert_allclose(resumed[k], straight[k], rtol=0,
                                   atol=1e-6, err_msg=k)
