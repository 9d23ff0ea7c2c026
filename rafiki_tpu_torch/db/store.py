"""An in-memory store of models, train jobs and trials.

Stands in for ``rafiki_tpu/db/database.py`` until the control-plane slice
(ROADMAP.md). It keeps the rows the train worker and the inference worker
read and write, under the database's method names as
``rafiki_tpu/worker/train.py`` calls them: a model (template bytes and
class name), a train job (budget, dataset URIs), its sub-train-job
(model and advisor session), and trials. ``reserve_trial`` counts and
inserts under one lock, so parallel workers never overshoot the trial
budget. A COMPLETED trial carries its score and the path of its params
artifact; :meth:`TrialStore.get_trial_params` is what an inference worker
loads.
"""

from __future__ import annotations

import copy
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.sdk.artifact import read_artifact


class TrialStatus:
    """As ``rafiki_tpu/constants.py``."""

    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ERRORED = "ERRORED"
    TERMINATED = "TERMINATED"


class BudgetType:
    """As ``rafiki_tpu/constants.py`` (the keys this slice reads)."""

    MODEL_TRIAL_COUNT = "MODEL_TRIAL_COUNT"


class TrialStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._models: Dict[str, Dict[str, Any]] = {}
        self._train_jobs: Dict[str, Dict[str, Any]] = {}
        self._sub_train_jobs: Dict[str, Dict[str, Any]] = {}
        self._trials: Dict[str, Dict[str, Any]] = {}
        self._trial_logs: Dict[str, List[str]] = {}

    def _get(self, table: Dict[str, Dict[str, Any]],
             key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = table.get(key)
            return copy.deepcopy(row) if row is not None else None

    # -- models and jobs ------------------------------------------------------

    def create_model(self, model_file_bytes: bytes, model_class: str,
                     name: Optional[str] = None) -> Dict[str, Any]:
        mid = uuid.uuid4().hex
        with self._lock:
            self._models[mid] = {"id": mid, "name": name or model_class,
                                 "model_file_bytes": model_file_bytes,
                                 "model_class": model_class}
        return self.get_model(mid)

    def get_model(self, model_id: str) -> Optional[Dict[str, Any]]:
        return self._get(self._models, model_id)

    def create_train_job(self, budget: Dict[str, Any],
                         train_dataset_uri: str,
                         test_dataset_uri: str) -> Dict[str, Any]:
        jid = uuid.uuid4().hex
        with self._lock:
            self._train_jobs[jid] = {
                "id": jid, "budget": dict(budget),
                "train_dataset_uri": train_dataset_uri,
                "test_dataset_uri": test_dataset_uri,
                "datetime_started": time.time()}
        return self.get_train_job(jid)

    def get_train_job(self, train_job_id: str) -> Optional[Dict[str, Any]]:
        return self._get(self._train_jobs, train_job_id)

    def create_sub_train_job(self, train_job_id: str,
                             model_id: str) -> Dict[str, Any]:
        sid = uuid.uuid4().hex
        with self._lock:
            self._sub_train_jobs[sid] = {
                "id": sid, "train_job_id": train_job_id,
                "model_id": model_id, "advisor_id": None}
        return self.get_sub_train_job(sid)

    def get_sub_train_job(self,
                          sub_train_job_id: str) -> Optional[Dict[str, Any]]:
        return self._get(self._sub_train_jobs, sub_train_job_id)

    def update_sub_train_job_advisor(self, sub_train_job_id: str,
                                     advisor_id: str) -> None:
        with self._lock:
            self._sub_train_jobs[sub_train_job_id]["advisor_id"] = advisor_id

    # -- trials ---------------------------------------------------------------

    def _new_trial(self, sub_train_job_id: Optional[str], model_id: str,
                   knobs: Dict[str, Any], worker_id: Optional[str],
                   trial_id: Optional[str] = None) -> str:
        """Insert a RUNNING trial row; the caller holds the lock."""
        tid = trial_id or uuid.uuid4().hex
        self._trials[tid] = {
            "id": tid, "sub_train_job_id": sub_train_job_id,
            "model_id": model_id, "worker_id": worker_id,
            "knobs": dict(knobs), "status": TrialStatus.RUNNING,
            "score": None, "params_file_path": None, "params_bytes": None,
            "fault_kind": None, "fault_detail": None,
            "datetime_started": time.time(), "datetime_stopped": None}
        return tid

    def reserve_trial(self, sub_train_job_id: str, model_id: str,
                      knobs: Dict[str, Any], worker_id: Optional[str] = None,
                      max_trials: Optional[int] = None
                      ) -> Optional[Dict[str, Any]]:
        """Create a RUNNING trial iff the sub-train-job's budget allows it
        (every trial but a TERMINATED one counts); the count and the insert
        happen under one lock. Returns the row, or None when the budget is
        spent."""
        with self._lock:
            if max_trials is not None:
                used = sum(1 for t in self._trials.values()
                           if t["sub_train_job_id"] == sub_train_job_id
                           and t["status"] != TrialStatus.TERMINATED)
                if used >= max_trials:
                    return None
            tid = self._new_trial(sub_train_job_id, model_id, knobs,
                                  worker_id)
        return self.get_trial(tid)

    def add_trial(self, trial_id: str, model_file_bytes: bytes,
                  model_class: str, knobs: Dict[str, Any],
                  params_bytes: bytes) -> None:
        """A COMPLETED trial whose parameters are given as artifact bytes
        (``sdk/params.py``) rather than trained here: what an inference
        job serves when the weights come from elsewhere."""
        mid = self.create_model(model_file_bytes, model_class)["id"]
        with self._lock:
            self._new_trial(None, mid, knobs, None, trial_id)
            self._trials[trial_id].update(status=TrialStatus.COMPLETED,
                                          params_bytes=params_bytes,
                                          datetime_stopped=time.time())

    def get_trial(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self._get(self._trials, trial_id)

    def get_trial_params(self, trial_id: str) -> bytes:
        """The params artifact of a COMPLETED trial: read and verified from
        its file (``sdk/artifact.py``), or the bytes it was added with."""
        trial = self.get_trial(trial_id)
        if trial is None or trial["status"] != TrialStatus.COMPLETED:
            raise KeyError(f"no completed trial {trial_id}")
        if trial["params_file_path"] is not None:
            return read_artifact(trial["params_file_path"])
        return trial["params_bytes"]

    def get_trials_of_sub_train_job(
            self, sub_train_job_id: str) -> List[Dict[str, Any]]:
        with self._lock:
            rows = [copy.deepcopy(t) for t in self._trials.values()
                    if t["sub_train_job_id"] == sub_train_job_id]
        return sorted(rows, key=lambda t: t["datetime_started"])

    def _finish(self, trial_id: str, status: str, **fields: Any) -> None:
        with self._lock:
            self._trials[trial_id].update(status=status,
                                          datetime_stopped=time.time(),
                                          **fields)

    def mark_trial_as_complete(self, trial_id: str, score: float,
                               params_file_path: Optional[str]) -> None:
        self._finish(trial_id, TrialStatus.COMPLETED, score=score,
                     params_file_path=params_file_path)

    def mark_trial_as_errored(self, trial_id: str,
                              fault_kind: Optional[str] = None,
                              fault_detail: Optional[str] = None) -> None:
        self._finish(trial_id, TrialStatus.ERRORED, fault_kind=fault_kind,
                     fault_detail=fault_detail)

    def mark_trial_as_terminated(self, trial_id: str) -> None:
        self._finish(trial_id, TrialStatus.TERMINATED)

    def add_trial_log(self, trial_id: str, line: str) -> None:
        with self._lock:
            self._trial_logs.setdefault(trial_id, []).append(line)

    def get_trial_logs(self, trial_id: str) -> List[str]:
        with self._lock:
            return list(self._trial_logs.get(trial_id, []))
