"""Inference worker: serves one trial's model with continuous batching.

Counterpart of ``rafiki_tpu/worker/inference.py``: register a queue with
the broker, load the trial (its model's template bytes, its knobs, its
params artifact, as a train job left them in the database), warm every
batch bucket up before reporting ready, then take batches and resolve
their futures. Each served batch counts into :func:`serving_stats`
(batches, queries, and the queue's depth, expired and shed queries),
which ``Admin.get_inference_job_stats`` reads. Chaos injection, the
sandbox, the remote stats reporter and fused ensembles are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List

import numpy as np

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import Broker
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext, set_device_grant
from rafiki_tpu_torch.sdk.artifact import read_artifact
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.sdk.params import load_params

logger = logging.getLogger(__name__)

# serving counters of this process's workers, by service id
_stats_lock = threading.Lock()
SERVING_STATS: Dict[str, Dict[str, int]] = {}  # guarded-by: _stats_lock


def serving_stats() -> Dict[str, Dict[str, int]]:
    """Snapshot of {service_id: {batches, queries, queue_depth, expired,
    shed}} for this process."""
    with _stats_lock:
        return {k: dict(v) for k, v in SERVING_STATS.items()}


def _record_batch(service_id: str, n_queries: int, queue) -> None:
    q = queue.stats()
    with _stats_lock:
        s = SERVING_STATS.setdefault(service_id, {"batches": 0, "queries": 0})
        s["batches"] += 1
        s["queries"] += n_queries
        s.update(queue_depth=q["depth"], expired=q["expired"],
                 shed=q["rejected"])


def _resolve_batch(futures: List[Any], predictions: Any,
                   service_id: str) -> None:
    """Resolve every future of a served batch; when the model returned fewer
    predictions than queries, the rest fail with a typed error."""
    n = len(predictions)
    for fut, pred in zip(futures, predictions):
        fut.set_result(pred)
    if n < len(futures):
        logger.error("model in worker %s returned %d predictions for %d "
                     "queries", service_id, n, len(futures))
        err = RuntimeError(
            f"model returned {n} predictions for {len(futures)} queries")
        for fut in futures[n:]:
            fut.set_error(err)


def _assemble(queries: List[Any]) -> Any:
    """One contiguous (n, ...) array when the queries are ndarrays of one
    shape and numeric dtype; otherwise the list as it came."""
    first = queries[0]
    if (isinstance(first, np.ndarray) and first.dtype.kind in "biuf"
            and all(isinstance(q, np.ndarray) and q.dtype == first.dtype
                    and q.shape == first.shape for q in queries)):
        return np.stack(queries)
    return queries


class InferenceWorker:
    def __init__(self, inference_job_id: str, trial_id: str, db: Database,
                 broker: Broker):
        self._job_id = inference_job_id
        self._trial_id = trial_id
        self._db = db
        self._broker = broker

    def _load_model(self):
        trial = self._db.get_trial(self._trial_id)
        if trial is None or not trial["params_file_path"]:
            raise KeyError(f"no trained trial {self._trial_id}")
        model_row = self._db.get_model(trial["model_id"])
        clazz = load_model_class(model_row["model_file_bytes"],
                                 model_row["model_class"])
        model = clazz(**trial["knobs"])
        # verified read: a damaged artifact raises ArtifactCorruptError
        model.load_parameters(
            load_params(read_artifact(trial["params_file_path"])))
        return model

    def start(self, ctx: ServiceContext) -> None:
        """Serve until ``ctx`` stops or the queue closes. Runs in the
        calling thread, on the devices ``ctx`` grants."""
        set_device_grant(ctx.chips)
        model = None
        queue = self._broker.register_worker(self._job_id, ctx.service_id)
        try:
            model = self._load_model()
            model.warm_up()  # every bucket runs before traffic arrives
            ctx.ready()
            while not ctx.stopping:
                batch = queue.take_batch(
                    max_size=config.PREDICT_MAX_BATCH_SIZE,
                    deadline_s=config.PREDICT_BATCH_DEADLINE_MS / 1000.0)
                if batch is None:
                    logger.info("query queue closed; worker %s exiting",
                                ctx.service_id)
                    break
                if not batch:
                    continue
                _record_batch(ctx.service_id, len(batch), queue)
                futures = [f for f, _ in batch]
                try:
                    predictions = model.predict(_assemble([q for _, q in batch]))
                    _resolve_batch(futures, predictions, ctx.service_id)
                except Exception as e:
                    logger.exception("predict failed in worker %s",
                                     ctx.service_id)
                    for fut in futures:
                        fut.set_error(e)
        finally:
            self._broker.unregister_worker(self._job_id, ctx.service_id)
            if model is not None:
                model.destroy()
            set_device_grant(None)
