"""Inference worker: serves one trial's model with continuous batching.

Counterpart of ``rafiki_tpu/worker/inference.py``: register a queue with
the broker, load the trial (its model's template bytes, its knobs, its
params artifact, as a train job left them in the database), warm every
batch bucket up before reporting ready, then take batches and resolve
their futures. Each served batch counts into :func:`serving_stats`
(batches, queries, and the queue's depth, expired and shed queries),
which ``Admin.get_inference_job_stats`` reads; a worker process relays
its counters to the admin (``report_stats``), which cannot see them.

A worker granted several devices (budget ``CHIPS_PER_WORKER``) is rank 0
of a group of ranks (``parallel/ranks.py``): its followers, one process a
device, load the same trial and warm it up, and each batch is split in
order into one contiguous part a device, answered by each rank alone on
its own device and gathered in order (a rank whose part is empty does
nothing). A part goes to its follower down its pipe. A follower that
fails a batch fails it as one device would; one that dies leaves the
ranks broken, and the worker fails its batch and stops (a process-placed
worker is started again by its placement).

A fused-ensemble worker (budget ``ENSEMBLE_FUSED``; ``trial_ids``) loads
every best trial and answers each batch with the final cross-trial
ensemble (:class:`_FusedEnsembleModel`): in ONE vmapped forward over the
trials' stacked parameters when their template's ``ensemble_stack``
fuses them, else one model after another. Its stats row says which
(``fused_dispatch``). Over several devices every rank holds the whole
group and answers its part of each batch for every trial.

A ``RAFIKI_CHAOS`` rule at site ``worker`` (target
``"{inference_job_id}/{service_id}"``) is asked once a batch, between
the take and the forward: ``delay`` sleeps, ``drop`` leaves the batch's
futures unresolved, ``error`` fails them.

Under the sandbox (``RAFIKI_SANDBOX=1``) the template answers from a
locked-down child (``sdk/sandbox.py`` :class:`SandboxedModelServer`, on
the grant's first device; it warms up before its ready frame) while this
worker keeps the store, the params file and the data plane. A child
that died never recovers: the worker fails the batch and exits, and its
placement starts it again. A fused ensemble is refused under the sandbox
at deploy (``admin/services.py``). The template's declared dependencies
are checked before it loads (``sdk/deps.py``).

The serving counters are mirrored into the metrics registry under JAX's
names (``rafiki_serving_{batches,queries}_total``,
``rafiki_serving_batch_size``, ``rafiki_queue_depth``,
``rafiki_worker_phase_seconds``). A batch holding a sampled request
records its ``batch_assembly`` and ``model_forward`` spans into the
request's trace (``QueryFuture.trace``, or the shm frame's responder,
which adds ``codec_encode`` when it writes the answer).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import Broker
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext, set_device_grant
from rafiki_tpu_torch.parallel.ranks import Ranks, load_params_file
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
from rafiki_tpu_torch.sdk import sandbox
from rafiki_tpu_torch.sdk.artifact import read_artifact
from rafiki_tpu_torch.sdk.deps import activate_prefix, ensure_dependencies
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

#: seconds between a worker process's relays of its serving counters
REPORT_INTERVAL_S = 5.0
#: the event that relays them to the admin; payload: service_id and the
#: counters of :func:`serving_stats`
EVENT_INFERENCE_WORKER_STATS = "inference_worker_stats"

# serving counters of this process's workers, by service id
_stats_lock = threading.Lock()
SERVING_STATS: Dict[str, Dict[str, int]] = {}  # guarded-by: _stats_lock


def _metrics() -> Dict[str, Any]:
    """The registry mirrors of the serving counters (made at first use;
    the registry returns the same ones after)."""
    return {
        "batches": REGISTRY.counter(
            "rafiki_serving_batches_total",
            "batches served by inference workers in this process"),
        "queries": REGISTRY.counter(
            "rafiki_serving_queries_total",
            "queries served by inference workers in this process"),
        "batch_size": REGISTRY.histogram(
            "rafiki_serving_batch_size",
            "queries per served batch (continuous-batching occupancy)",
            buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256]),
        "depth": REGISTRY.gauge(
            "rafiki_queue_depth", "current worker-queue depth",
            ("service",)),
        "phase": REGISTRY.histogram(
            "rafiki_worker_phase_seconds",
            "worker-side phase latency per served batch", ("phase",)),
    }


def serving_stats() -> Dict[str, Dict[str, int]]:
    """Snapshot of {service_id: {batches, queries, queue_depth, expired,
    shed}} for this process."""
    with _stats_lock:
        return {k: dict(v) for k, v in SERVING_STATS.items()}


def _record_fused(service_id: str, fused: bool) -> None:
    with _stats_lock:
        s = SERVING_STATS.setdefault(service_id, {"batches": 0, "queries": 0})
        s["fused_dispatch"] = fused


def _record_batch(service_id: str, n_queries: int, queue) -> None:
    # an shm worker queue knows no depth or shed count: those are the
    # predictor's side of the ring
    q = queue.stats()
    with _stats_lock:
        s = SERVING_STATS.setdefault(service_id, {"batches": 0, "queries": 0})
        s["batches"] += 1
        s["queries"] += n_queries
        s.update(queue_depth=q.get("depth", 0), expired=q["expired"],
                 shed=q.get("rejected", 0))
    m = _metrics()
    m["batches"].inc()
    m["queries"].inc(n_queries)
    m["batch_size"].observe(n_queries)
    if "depth" in q:
        m["depth"].labels(service_id).set(int(q["depth"]))
        REGISTRY.ring(f"queue_depth:{service_id}").record(int(q["depth"]))


def _trace_sinks(futures: List[Any]) -> List[Any]:
    """The span sinks of a batch's sampled requests, one a request: an
    in-process future's ``RequestTrace``, an shm handle's responder."""
    sinks: List[Any] = []
    for f in futures:
        sink = getattr(f, "trace", None)
        if sink is not None and all(x is not sink for x in sinks):
            sinks.append(sink)
    return sinks


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
    stacked = wire.stack_batch(queries)
    return queries if stacked is None else stacked


def _split(queries: Any, n: int) -> List[Any]:
    """``queries`` (an array or a list) in ``n`` contiguous parts in
    order, the first ones a query longer where they do not divide."""
    size, extra = divmod(len(queries), n)
    parts, start = [], 0
    for r in range(n):
        end = start + size + (r < extra)
        parts.append(queries[start:end])
        start = end
    return parts


class _FusedEnsembleModel:
    """The fused-ensemble serving unit: every best trial's model in this
    worker, answering each batch as one unit with the final ensemble.
    When the template's ``ensemble_stack`` fuses the group, the whole
    ensemble is one vmapped forward; when it returns None, or raises (it
    is template code: a raising hook is logged and the group served one
    model after another, never a failed worker start), the models answer
    in turn. The predictor treats the group as one trial."""

    def __init__(self, models: List[Any], task: Optional[str]):
        self._models = models
        self._task = task
        self._stacked = None
        stack_fn = getattr(models[0], "ensemble_stack", None)
        if callable(stack_fn):
            try:
                self._stacked = stack_fn(models)
            except Exception:
                logger.exception(
                    "fused worker: ensemble_stack hook raised; serving %d "
                    "models one after another", len(models))
        if self._stacked is None and len(models) > 1:
            logger.info("fused worker: the trials share no stacked predict; "
                        "serving %d models one after another", len(models))

    @property
    def fused_dispatch(self) -> bool:
        return self._stacked is not None

    def predict(self, queries):
        if self._stacked is not None:
            per_model = self._stacked.predict_all(queries)
        else:
            per_model = [m.predict(queries) for m in self._models]
        return [ensemble_predictions([pm[i] for pm in per_model], self._task)
                for i in range(len(queries))]

    def warm_up(self) -> None:
        if self._stacked is not None:
            self._stacked.warm_up()
        else:
            for m in self._models:
                m.warm_up()

    def destroy(self) -> None:
        for m in self._models:
            try:
                m.destroy()
            except Exception:
                logger.exception("destroy failed for a fused-ensemble model")


def load_fused(members: List[tuple], task: Optional[str]
               ) -> _FusedEnsembleModel:
    """A fused ensemble of ``members``, each ``(template bytes, class
    name, knobs, params path)``, built in this process (a rank of a
    several-device worker builds its own)."""
    models = []
    for model_bytes, class_name, knobs, params_path in members:
        model = load_model_class(model_bytes, class_name)(**knobs)
        load_params_file(model, params_path)
        models.append(model)
    return _FusedEnsembleModel(models, task)


class InferenceWorker:
    def __init__(self, inference_job_id: str, trial_id: str, db: Database,
                 broker: Broker,
                 report_stats: Optional[Callable[[Dict[str, Any]],
                                                 None]] = None,
                 trial_ids: Optional[List[str]] = None):
        """``report_stats({"service_id", "batches", "queries", ...})``
        relays this worker's cumulative counters to a remote admin, from a
        thread, every ``REPORT_INTERVAL_S`` and once more at exit;
        best-effort. ``trial_ids`` makes the worker a fused ensemble of
        those trials (budget ``ENSEMBLE_FUSED``); ``trial_id`` is then the
        group's top trial, its bookkeeping row."""
        self._job_id = inference_job_id
        self._trial_id = trial_id
        self._trial_ids = list(trial_ids) if trial_ids else [trial_id]
        self._db = db
        self._broker = broker
        self._report_stats = report_stats

    def _stats_reporter(self, ctx: ServiceContext,
                        done: threading.Event) -> None:
        """Push the counters on a fixed beat, whatever the traffic, the
        first at once and the last when ``done`` is set; a push that fails
        is tried again at the next."""
        last = None

        def push():
            nonlocal last
            s = serving_stats().get(ctx.service_id,
                                    {"batches": 0, "queries": 0})
            if s == last:
                return
            try:
                self._report_stats({"service_id": ctx.service_id, **s})
                last = s
            except Exception:
                logger.warning("stats report failed (continuing)",
                               exc_info=True)

        push()
        while not done.wait(REPORT_INTERVAL_S):
            push()
        push()  # the batches since the last beat

    def _load_model(self, ranks: Optional[Ranks] = None,
                    ctx: Optional[ServiceContext] = None):
        if len(self._trial_ids) > 1:
            return self._load_fused(ranks)
        return self._load_trial(self._trial_id, ranks, ctx)

    def _load_trial(self, trial_id: str, ranks: Optional[Ranks] = None,
                    ctx: Optional[ServiceContext] = None):
        """One trained trial's model, its parameters loaded (on every
        rank of ``ranks``), or, under the sandbox, its server in a child
        on the first device of ``ctx``'s grant."""
        trial = self._db.get_trial(trial_id)
        if trial is None or not trial["params_file_path"]:
            raise KeyError(f"no trained trial {trial_id}")
        model_row = self._db.get_model(trial["model_id"])
        prefix = ensure_dependencies(model_row.get("dependencies"))
        if sandbox.sandbox_enabled():
            # the template answers from a locked-down child; this worker
            # keeps the params file, the store and the data plane
            return sandbox.SandboxedModelServer(
                model_row["model_file_bytes"], model_row["model_class"],
                trial["knobs"], read_artifact(trial["params_file_path"]),
                sandbox.make_jail(config.WORKDIR, "serve-" + (
                    ctx.service_id if ctx is not None else trial_id)),
                extra_pythonpath=prefix,
                devices=list(ctx.chips)[:1] if ctx is not None else None)
        activate_prefix(prefix)
        clazz = load_model_class(model_row["model_file_bytes"],
                                 model_row["model_class"])
        model = clazz(**trial["knobs"])
        # verified read: a damaged artifact raises ArtifactCorruptError
        if ranks is None:
            load_params_file(model, trial["params_file_path"])
        else:
            ranks.new_model(model_row["model_file_bytes"],
                            model_row["model_class"], trial["knobs"])
            ranks.load(model, trial["params_file_path"])
        return model

    def _load_fused(self, ranks: Optional[Ranks]) -> _FusedEnsembleModel:
        members = []
        for tid in self._trial_ids:
            trial = self._db.get_trial(tid)
            if trial is None or not trial["params_file_path"]:
                raise KeyError(f"no trained trial {tid}")
            model_row = self._db.get_model(trial["model_id"])
            members.append((model_row["model_file_bytes"],
                            model_row["model_class"], trial["knobs"],
                            trial["params_file_path"]))
        inf = self._db.get_inference_job(self._job_id)
        task = self._db.get_train_job(inf["train_job_id"])["task"]
        if ranks is not None:
            ranks.new_fused(members, task)
        return load_fused(members, task)

    def start(self, ctx: ServiceContext) -> None:
        """Serve until ``ctx`` stops or the queue closes. Runs in the
        calling thread, on the devices ``ctx`` grants."""
        set_device_grant(ctx.chips)
        model = reporter = ranks = None
        done = threading.Event()
        queue = self._broker.register_worker(self._job_id, ctx.service_id)

        def predict(queries: Any) -> Any:
            if ranks is None:
                return model.predict(queries)
            parts = _split(queries, ranks.size)
            answers = ranks.each(model, "predict", [
                (part,) if len(part) else None for part in parts])
            return [a for part in answers if part is not None
                    for a in part]

        try:
            if len(ctx.chips) > 1 and not sandbox.sandbox_enabled():
                ranks = Ranks(ctx.chips)
            model = self._load_model(ranks, ctx)
            # every bucket runs before traffic arrives, on every device
            if ranks is None:
                model.warm_up()
            else:
                ranks.each(model, "warm_up", [()] * ranks.size)
            if isinstance(model, _FusedEnsembleModel):
                _record_fused(ctx.service_id, model.fused_dispatch)
            ctx.ready()
            if self._report_stats is not None:
                reporter = threading.Thread(
                    target=self._stats_reporter, args=(ctx, done),
                    name="stats-reporter", daemon=True)
                reporter.start()
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
                sinks = _trace_sinks(futures)
                t_asm = time.monotonic()
                queries = _assemble([q for _, q in batch])
                t_fwd = time.monotonic()
                for sink in sinks:
                    sink.add_span("batch_assembly", t_asm, t_fwd)
                rule = chaos.hit(chaos.SITE_WORKER,
                                 f"{self._job_id}/{ctx.service_id}")
                if rule is not None:
                    # the overload drills (RAFIKI_CHAOS site=worker): a
                    # slow replica, a silent one (its futures never
                    # resolve: the predictor's deadline and hedges own
                    # recovery), a failing one
                    if rule.action == chaos.ACTION_DELAY:
                        chaos.sleep_for(rule)
                    elif rule.action == chaos.ACTION_DROP:
                        logger.warning("chaos: worker %s stalling a "
                                       "%d-query batch", ctx.service_id,
                                       len(batch))
                        continue
                    else:
                        err = RuntimeError("chaos-injected worker error")
                        for fut in futures:
                            fut.set_error(err)
                        continue
                try:
                    t_pred = time.monotonic()
                    predictions = predict(queries)
                    t_done = time.monotonic()
                    m = _metrics()
                    m["phase"].labels("batch_assembly").observe(
                        t_fwd - t_asm)
                    m["phase"].labels("model_forward").observe(
                        t_done - t_pred)
                    for sink in sinks:
                        sink.add_span("model_forward", t_pred, t_done)
                    _resolve_batch(futures, predictions, ctx.service_id)
                except Exception as e:
                    logger.exception("predict failed in worker %s",
                                     ctx.service_id)
                    for fut in futures:
                        fut.set_error(e)
                    if ranks is not None and ranks.broken:
                        raise  # a follower is gone
                    if getattr(model, "dead", False):
                        # a dead sandbox child never recovers: exit, and
                        # the placement starts this worker again
                        raise
        finally:
            self._broker.unregister_worker(self._job_id, ctx.service_id)
            if model is not None:
                model.destroy()
            if ranks is not None:
                ranks.close()
            set_device_grant(None)
            done.set()
            if reporter is not None:
                reporter.join(timeout=10)
