"""Settings, read from the same environment names with the same defaults
as ``rafiki_tpu/config.py``.

Paths, the settings a live deployment may retune
(``PREDICT_QUEUE_DEPTH``, the per-job doors ``PREDICTOR_PORTS`` and
``PREDICTOR_HOST``, the generation worker's and the door's ``GEN_*``
(speculation and stream continuity among them), the trial fault
settings ``TRIAL_*`` (vectorized trials' ``TRIAL_VMAP`` and
``TRIAL_VMAP_K`` among them), ``PENDING_FEEDBACK_MAX``, and the fleet's
knobs: the autoscaler's, fair admission's and the warm pool's
``AUTOSCALE_*``, ``GEN_OCCUPANCY_HIGH``, the rollouts' ``ROLLOUT_*`` and
the drift loop's ``DRIFT_*``, crash recovery's ``RECOVER_*`` (the
agents' probe budget ``RECOVER_PROBE_TIMEOUT_S`` among them) and
control-plane HA's ``ADMIN_HA``, ``ADMIN_LEASE_*``, ``ADMIN_ADDRS``,
``ADMIN_FAILOVER_TIMEOUT_S``, ``ADMIN_STANDBY_POLL_S`` and
``RECOVERY_REPORT_KEEP``)
and the wall-clock
budgets (``PREDICT_TIMEOUT_S``, ``SERVICE_DEPLOY_TIMEOUT_S``,
``DIST_TIMEOUT_S``) are read
at each use (module ``__getattr__``), so a test or an operator
can repoint ``RAFIKI_WORKDIR`` or give a loaded host longer budgets
without re-importing (the JAX package reads the two budgets once, at
import).
One default differs: the metadata store is
``WORKDIR/rafiki_torch.sqlite3``, so the two packages never open one
file with different schemas.

:func:`refuse_unported` turns the settings that would select a subsystem
the port does not have yet into a typed :class:`NotPortedError`, and so a
``RAFIKI_CHAOS`` rule at a site whose hook the port lacks.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


SUPERADMIN_EMAIL = os.environ.get("SUPERADMIN_EMAIL", "superadmin@rafiki")
SUPERADMIN_PASSWORD = os.environ.get("SUPERADMIN_PASSWORD", "rafiki")

APP_SECRET = os.environ.get("APP_SECRET", "rafiki-tpu-dev-secret")
TOKEN_TTL_HOURS = _env_int("TOKEN_TTL_HOURS", 24)

#: serving fleet of an inference job: the best trials, and replicas of each
INFERENCE_MAX_BEST_TRIALS = _env_int("INFERENCE_MAX_BEST_TRIALS", 2)
INFERENCE_WORKER_REPLICAS_PER_TRIAL = _env_int(
    "INFERENCE_WORKER_REPLICAS_PER_TRIAL", 2)

#: most queries an inference worker serves in one batch
PREDICT_MAX_BATCH_SIZE = _env_int("PREDICT_MAX_BATCH_SIZE", 64)
#: coalescing wait after the first query of a batch (0 = serve at once)
PREDICT_BATCH_DEADLINE_MS = _env_float("PREDICT_BATCH_DEADLINE_MS", 0.0)
#: request-body ceiling on the /predict door (413 above it)
PREDICT_MAX_BODY_MB = _env_float("PREDICT_MAX_BODY_MB", 64.0)
#: how long the admin door reuses an app's resolved predictor
PREDICT_ROUTE_TTL_S = _env_float("PREDICT_ROUTE_TTL_S", 5.0)
#: request-body ceiling on the admin door (a model upload is base64 JSON)
ADMIN_MAX_BODY_MB = _env_float("ADMIN_MAX_BODY_MB", 256.0)
#: trials per train job when its budget names no MODEL_TRIAL_COUNT
DEFAULT_TRIAL_COUNT = _env_int("DEFAULT_TRIAL_COUNT", 5)


# -- fleet health of host placement (placement/hosts.py): each agent's
# /healthz is probed every AGENT_HEARTBEAT_INTERVAL_S (0: no monitor),
# AGENT_DOWN_THRESHOLD misses in a row mark it DOWN; an idempotent agent
# call retries a transport failure up to AGENT_RETRY_MAX times (backoff
# from AGENT_RETRY_BACKOFF_S, full jitter); AGENT_BREAKER_THRESHOLD
# transport failures in a row open an agent's circuit, which lets one
# probe through after AGENT_BREAKER_COOLDOWN_S
AGENT_HEARTBEAT_INTERVAL_S = _env_float("RAFIKI_AGENT_HEARTBEAT_S", 5.0)
AGENT_DOWN_THRESHOLD = _env_int("RAFIKI_AGENT_DOWN_THRESHOLD", 3)
AGENT_HEARTBEAT_TIMEOUT_S = _env_float("RAFIKI_AGENT_HEARTBEAT_TIMEOUT_S", 2.0)
AGENT_RETRY_MAX = _env_int("RAFIKI_AGENT_RETRY_MAX", 2)
AGENT_RETRY_BACKOFF_S = _env_float("RAFIKI_AGENT_RETRY_BACKOFF_S", 0.1)
AGENT_BREAKER_THRESHOLD = _env_int("RAFIKI_AGENT_BREAKER_THRESHOLD", 3)
AGENT_BREAKER_COOLDOWN_S = _env_float("RAFIKI_AGENT_BREAKER_COOLDOWN_S", 5.0)


def workdir() -> str:
    return os.environ.get("RAFIKI_WORKDIR", os.path.abspath("."))


_DYNAMIC = {
    "WORKDIR": workdir,
    # where train workers write trial params and checkpoints
    "PARAMS_DIR": lambda: os.environ.get(
        "RAFIKI_PARAMS_DIR", os.path.join(workdir(), "params")),
    # the metadata store: RAFIKI_DB_URL wins over RAFIKI_DB_PATH, as in
    # the JAX package (the port's Database refuses a postgresql:// URL)
    "DB_PATH": lambda: (
        os.environ.get("RAFIKI_DB_URL")
        or os.environ.get("RAFIKI_DB_PATH")
        or os.path.join(workdir(), "rafiki_torch.sqlite3")),
    # per-worker inbox cap; submits beyond it raise QueueFullError
    # (0 = uncapped)
    "PREDICT_QUEUE_DEPTH": lambda: _env_int("RAFIKI_PREDICT_QUEUE_DEPTH", 256),
    # -- admission at the serving doors (predictor/admission.py): requests
    # in flight a door admits before it answers 503 (0: no cap)
    "PREDICT_MAX_INFLIGHT": lambda: _env_int(
        "RAFIKI_PREDICT_MAX_INFLIGHT", 64),
    # a hedge to a sibling replica deeper than this is held back (0: never)
    "PREDICT_HEDGE_SUPPRESS_DEPTH": lambda: _env_int(
        "RAFIKI_PREDICT_HEDGE_SUPPRESS_DEPTH", PREDICT_MAX_BATCH_SIZE),
    # seconds a per-job door's stop() waits for the requests in flight
    "PREDICT_DRAIN_S": lambda: _env_float("RAFIKI_PREDICT_DRAIN_S", 5.0),
    # -- the predict result cache (predictor/result_cache.py), off by
    # default as in the JAX package: identical queries to a job answered
    # from a bounded cache keyed (digest, job, serving version)
    "PREDICT_CACHE": lambda: os.environ.get(
        "RAFIKI_PREDICT_CACHE", "0") == "1",
    "PREDICT_CACHE_TTL_S": lambda: _env_float(
        "RAFIKI_PREDICT_CACHE_TTL_S", 30.0),
    "PREDICT_CACHE_MAX_BYTES": lambda: _env_int(
        "RAFIKI_PREDICT_CACHE_MAX_BYTES", 64 * 1024 * 1024),
    # 0: concurrent identical misses each pay their own forward
    "PREDICT_SINGLEFLIGHT": lambda: os.environ.get(
        "RAFIKI_PREDICT_SINGLEFLIGHT", "1") != "0",
    # where a process-placed service's log goes (service-<id>.log)
    "LOGS_DIR": lambda: os.environ.get(
        "RAFIKI_LOGS_DIR", os.path.join(workdir(), "logs")),
    # bytes of each shm ring of the serving data plane (one query ring per
    # serving worker, one response ring per inference job); a request's
    # frame larger than the ring is refused (413)
    "SHM_RING_BYTES": lambda: _env_int("RAFIKI_SHM_RING_BYTES", 1 << 20),
    # default request deadline at the predictor
    "PREDICT_TIMEOUT_S": lambda: _env_float("PREDICT_TIMEOUT_S", 30.0),
    # how long a deploy waits for its services to report RUNNING
    "SERVICE_DEPLOY_TIMEOUT_S": lambda: _env_float(
        "SERVICE_DEPLOY_TIMEOUT_S", 60.0),
    # a dedicated HTTP door per inference job (POST /predict, /generate)
    "PREDICTOR_PORTS": lambda: (
        os.environ.get("RAFIKI_PREDICTOR_PORTS", "0") == "1"),
    "PREDICTOR_HOST": lambda: (
        os.environ.get("RAFIKI_PREDICTOR_HOST", "127.0.0.1")),
    # -- generative serving (worker/generation.py); a worker reads them
    # when it starts, a request when it is parsed:
    # co-resident sequences per generation worker (the width of the cache)
    "GEN_MAX_SLOTS": lambda: _env_int("RAFIKI_GEN_MAX_SLOTS", 8),
    # per-request decode budget cap (a larger ask is clamped)
    "GEN_MAX_TOKENS": lambda: _env_int("RAFIKI_GEN_MAX_TOKENS", 64),
    # the door's inter-token stall timeout: a stream with no delta for
    # this long ends with a typed terminal error frame
    "GEN_STREAM_TIMEOUT_S": lambda: _env_float(
        "RAFIKI_GEN_STREAM_TIMEOUT_S", 10.0),
    # 0: the contiguous ring a slot; 1: the paged allocator for templates
    # that implement the paged methods
    "GEN_KV_PAGED": lambda: os.environ.get(
        "RAFIKI_GEN_KV_PAGED", "1") != "0",
    # K/V rows a pool page
    "GEN_KV_BLOCK_TOKENS": lambda: _env_int(
        "RAFIKI_GEN_KV_BLOCK_TOKENS", 16),
    # pages in the pool; 0: the ring's capacity (slots x pages a context)
    "GEN_KV_POOL_BLOCKS": lambda: _env_int("RAFIKI_GEN_KV_POOL_BLOCKS", 0),
    # 0: never share prompt-prefix pages across streams
    "GEN_PREFIX_CACHE": lambda: os.environ.get(
        "RAFIKI_GEN_PREFIX_CACHE", "1") != "0",
    # prompt tokens ingested a scheduler round (0: one-shot prefill)
    "GEN_PREFILL_CHUNK": lambda: _env_int("RAFIKI_GEN_PREFILL_CHUNK", 64),
    # 0: greedy only; a sampled request gets a typed 400
    "GEN_SAMPLING": lambda: os.environ.get(
        "RAFIKI_GEN_SAMPLING", "1") != "0",
    # 0: never speculate; 1: draft-verify speculative decoding on the
    # paged path whenever the job's budget names a draft trial
    # (GEN_DRAFT_TRIAL) and the template verifies
    "GEN_SPEC": lambda: os.environ.get("RAFIKI_GEN_SPEC", "1") != "0",
    # draft tokens proposed a round (clamped to 1..16); the verify forward
    # is k+1 positions wide
    "GEN_SPEC_K": lambda: _env_int("RAFIKI_GEN_SPEC_K", 4),
    # -- stream continuity (predictor/predictor.py): the door journals each
    # stream and resumes it on a sibling when its replica dies or hands
    # it back; resume attempts a stream (0: no resume)
    "GEN_RESUME_MAX": lambda: _env_int("RAFIKI_GEN_RESUME_MAX", 3),
    # base of the jittered backoff between attempts (attempt n waits up
    # to base * 2^(n-2), within the request's deadline)
    "GEN_RESUME_BACKOFF_S": lambda: _env_float(
        "RAFIKI_GEN_RESUME_BACKOFF_S", 0.05),
    # a stream's journal cap (prompt and committed tokens); past it the
    # stream goes on streaming but can no longer be resumed
    "GEN_JOURNAL_MAX_KB": lambda: _env_int("RAFIKI_GEN_JOURNAL_MAX_KB", 64),
    # a stream older than this is never resumed
    "GEN_JOURNAL_TTL_S": lambda: _env_float(
        "RAFIKI_GEN_JOURNAL_TTL_S", 600.0),
    # -- trial fault tolerance (worker/train.py, worker/faults.py), read
    # at each use so a live worker's next trial sees a change:
    # infra-class faults (INFRA, MEM, STALL) re-run under the same trial
    # id up to this many times (0: every fault burns its budget slot)
    "TRIAL_RETRY_MAX": lambda: _env_int("RAFIKI_TRIAL_RETRY_MAX", 2),
    # backoff base of those re-runs (exponential, full jitter)
    "TRIAL_RETRY_BACKOFF_S": lambda: _env_float(
        "RAFIKI_TRIAL_RETRY_BACKOFF_S", 0.5),
    # poison faults on near-identical knobs before their signature is
    # quarantined
    "TRIAL_QUARANTINE_K": lambda: _env_int("RAFIKI_TRIAL_QUARANTINE_K", 3),
    # proposals rejected a slot for a quarantined signature before the
    # worker accepts one
    "TRIAL_REPROPOSE_MAX": lambda: _env_int("RAFIKI_TRIAL_REPROPOSE_MAX", 8),
    # consecutive user-class faults that error the whole job (0: never)
    "TRIAL_FAULT_LIMIT": lambda: _env_int("RAFIKI_TRIAL_FAULT_LIMIT", 5),
    # 0: never train a bucket of proposals as one vectorized population,
    # even for templates that declare a population_spec (worker/train.py)
    "TRIAL_VMAP": lambda: os.environ.get("RAFIKI_TRIAL_VMAP", "1") != "0",
    # proposals drained a vectorized round (a job's budget TRIAL_VMAP_K
    # wins; the template's max_members caps it; below 2 it never engages)
    "TRIAL_VMAP_K": lambda: _env_int("RAFIKI_TRIAL_VMAP_K", 4),
    # advisor feedback queued for retry, at most (the oldest drop)
    "PENDING_FEEDBACK_MAX": lambda: _env_int(
        "RAFIKI_PENDING_FEEDBACK_MAX", 256),
    # -- several devices (parallel/ranks.py): seconds a rank waits on the
    # others, in a collective or for a reply, before the call fails
    "DIST_TIMEOUT_S": lambda: _env_float("RAFIKI_DIST_TIMEOUT_S", 300.0),
    # -- the serving autoscaler (admin/autoscaler.py), off by default:
    # its tick, the signal window, the shed count and mean backlog that
    # read overload, the backlog that still reads idle, the replica
    # bounds and step, the cooldowns after an action (down much longer
    # than up), a drained replica's window, and the cards serving may
    # never borrow into
    "AUTOSCALE": lambda: os.environ.get("RAFIKI_AUTOSCALE", "0") == "1",
    "AUTOSCALE_INTERVAL_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_INTERVAL_S", 2.0),
    "AUTOSCALE_WINDOW_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_WINDOW_S", 15.0),
    "AUTOSCALE_SHED_THRESHOLD": lambda: _env_int(
        "RAFIKI_AUTOSCALE_SHED_THRESHOLD", 3),
    "AUTOSCALE_DEPTH_HIGH": lambda: _env_float(
        "RAFIKI_AUTOSCALE_DEPTH_HIGH", 8.0),
    "AUTOSCALE_DEPTH_LOW": lambda: _env_float(
        "RAFIKI_AUTOSCALE_DEPTH_LOW", 1.0),
    "AUTOSCALE_MIN_REPLICAS": lambda: _env_int(
        "RAFIKI_AUTOSCALE_MIN_REPLICAS", 1),
    "AUTOSCALE_MAX_REPLICAS": lambda: _env_int(
        "RAFIKI_AUTOSCALE_MAX_REPLICAS", 8),
    "AUTOSCALE_STEP": lambda: _env_int("RAFIKI_AUTOSCALE_STEP", 1),
    "AUTOSCALE_COOLDOWN_UP_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_COOLDOWN_UP_S", 5.0),
    "AUTOSCALE_COOLDOWN_DOWN_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_COOLDOWN_DOWN_S", 30.0),
    "AUTOSCALE_DRAIN_S": lambda: _env_float("RAFIKI_AUTOSCALE_DRAIN_S", 10.0),
    "AUTOSCALE_TRAIN_FLOOR": lambda: _env_int(
        "RAFIKI_AUTOSCALE_TRAIN_FLOOR", 1),
    # weighted fair admission at the shared door: the half-life of a
    # tenant's admitted-query charge, the queries it may run past its
    # share, and the weights ("appA=3,appB=1"; unlisted tenants weigh 1)
    "AUTOSCALE_FAIR": lambda: os.environ.get(
        "RAFIKI_AUTOSCALE_FAIR", "0") == "1",
    "AUTOSCALE_FAIR_WINDOW_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_FAIR_WINDOW_S", 10.0),
    "AUTOSCALE_FAIR_BURST": lambda: _env_float(
        "RAFIKI_AUTOSCALE_FAIR_BURST", 32.0),
    "AUTOSCALE_FAIR_WEIGHTS": lambda: os.environ.get(
        "RAFIKI_AUTOSCALE_FAIR_WEIGHTS", ""),
    # the warm pool (admin/warm_pool.py): standbys kept a RUNNING job (0:
    # off), its tick, the failed placements in a row before a job's pool
    # is DEGRADED, and how long it then waits
    "AUTOSCALE_WARM_POOL": lambda: _env_int(
        "RAFIKI_AUTOSCALE_WARM_POOL", 0),
    "AUTOSCALE_WARM_POOL_INTERVAL_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_WARM_POOL_INTERVAL_S", 5.0),
    "AUTOSCALE_WARM_RETRY_MAX": lambda: _env_int(
        "RAFIKI_AUTOSCALE_WARM_RETRY_MAX", 3),
    "AUTOSCALE_WARM_RETRY_COOLDOWN_S": lambda: _env_float(
        "RAFIKI_AUTOSCALE_WARM_RETRY_COOLDOWN_S", 30.0),
    # mean generation occupancy over the autoscaler's window that reads
    # saturated (the binding resource: pool pages, or slots)
    "GEN_OCCUPANCY_HIGH": lambda: _env_float(
        "RAFIKI_GEN_OCCUPANCY_HIGH", 0.85),
    # -- live rollouts (admin/rollout.py): the canary's share of traffic,
    # the judge's trailing window, the canary requests a verdict needs,
    # the error-rate delta and p95 factor that breach, and the replicas
    # replaced a rolling batch
    "ROLLOUT_CANARY_FRACTION": lambda: _env_float(
        "RAFIKI_ROLLOUT_CANARY_FRACTION", 0.1),
    "ROLLOUT_JUDGE_WINDOW_S": lambda: _env_float(
        "RAFIKI_ROLLOUT_JUDGE_WINDOW_S", 10.0),
    "ROLLOUT_MIN_REQUESTS": lambda: _env_int(
        "RAFIKI_ROLLOUT_MIN_REQUESTS", 5),
    "ROLLOUT_ERR_DELTA": lambda: _env_float(
        "RAFIKI_ROLLOUT_ERR_DELTA", 0.1),
    "ROLLOUT_P95_FACTOR": lambda: _env_float(
        "RAFIKI_ROLLOUT_P95_FACTOR", 3.0),
    "ROLLOUT_BATCH": lambda: _env_int("RAFIKI_ROLLOUT_BATCH", 1),
    # -- the drift loop (admin/drift.py), off by default: the monitor's
    # tick interval, its trailing window and the baseline's, the samples
    # a window needs, the novelty, confidence-drop and skew thresholds,
    # the retrain's trial budget (0: monitor only), the base cooldown
    # (doubled a consecutive rollback, up to x16) and the launch retries
    # before the loop parks
    "DRIFT": lambda: os.environ.get("RAFIKI_DRIFT", "0") == "1",
    "DRIFT_INTERVAL_S": lambda: _env_float("RAFIKI_DRIFT_INTERVAL_S", 2.0),
    "DRIFT_WINDOW_S": lambda: _env_float("RAFIKI_DRIFT_WINDOW_S", 10.0),
    "DRIFT_BASELINE_WINDOW_S": lambda: _env_float(
        "RAFIKI_DRIFT_BASELINE_WINDOW_S", 10.0),
    "DRIFT_MIN_SAMPLES": lambda: _env_int("RAFIKI_DRIFT_MIN_SAMPLES", 20),
    "DRIFT_THRESHOLD": lambda: _env_float("RAFIKI_DRIFT_THRESHOLD", 0.5),
    "DRIFT_CONF_DROP": lambda: _env_float("RAFIKI_DRIFT_CONF_DROP", 0.2),
    "DRIFT_SKEW_DELTA": lambda: _env_float("RAFIKI_DRIFT_SKEW_DELTA", 0.4),
    "DRIFT_RETRAIN_BUDGET": lambda: _env_int(
        "RAFIKI_DRIFT_RETRAIN_BUDGET", 3),
    "DRIFT_COOLDOWN_S": lambda: _env_float("RAFIKI_DRIFT_COOLDOWN_S", 60.0),
    "DRIFT_LAUNCH_RETRY_MAX": lambda: _env_int(
        "RAFIKI_DRIFT_LAUNCH_RETRY_MAX", 2),
    # -- crash recovery (admin/recovery.py): adopt surviving workers (0:
    # fence them instead), each host agent's inventory probe budget, and
    # the bounded retry of a store step
    "RECOVER_ADOPT": lambda: os.environ.get(
        "RAFIKI_RECOVER_ADOPT", "1") != "0",
    "RECOVER_PROBE_TIMEOUT_S": lambda: _env_float(
        "RAFIKI_RECOVER_PROBE_TIMEOUT_S", 5.0),
    "RECOVER_RETRY_MAX": lambda: _env_int("RAFIKI_RECOVER_RETRY_MAX", 4),
    "RECOVER_RETRY_BACKOFF_S": lambda: _env_float(
        "RAFIKI_RECOVER_RETRY_BACKOFF_S", 0.2),
    # -- control-plane HA (admin/lease.py, admin/standby.py), off by
    # default: a leader acquires the lease at boot; its TTL and renewal
    # period (0: TTL/3); how long a booting leader waits out a
    # predecessor's lease; the clients' address list and how long a call
    # walks it; the standby's watch period (0: the renewal period); the
    # epoch-suffixed recovery reports kept
    "ADMIN_HA": lambda: _env_int("RAFIKI_ADMIN_HA", 0),
    "ADMIN_LEASE_TTL_S": lambda: _env_float("RAFIKI_ADMIN_LEASE_TTL_S", 10.0),
    "ADMIN_LEASE_RENEW_S": lambda: _env_float(
        "RAFIKI_ADMIN_LEASE_RENEW_S", 0.0),
    "ADMIN_LEASE_ACQUIRE_TIMEOUT_S": lambda: _env_float(
        "RAFIKI_ADMIN_LEASE_ACQUIRE_TIMEOUT_S", 30.0),
    "ADMIN_ADDRS": lambda: os.environ.get("RAFIKI_ADMIN_ADDRS", ""),
    "ADMIN_FAILOVER_TIMEOUT_S": lambda: _env_float(
        "RAFIKI_ADMIN_FAILOVER_TIMEOUT_S", 20.0),
    "ADMIN_STANDBY_POLL_S": lambda: _env_float(
        "RAFIKI_ADMIN_STANDBY_POLL_S", 0.0),
    "RECOVERY_REPORT_KEEP": lambda: _env_int(
        "RAFIKI_RECOVERY_REPORT_KEEP", 5),
}


def __getattr__(name: str):
    if name in _DYNAMIC:
        return _DYNAMIC[name]()
    raise AttributeError(name)


class NotPortedError(RuntimeError):
    """A setting asks for a subsystem that ``rafiki_tpu_torch`` does not
    have yet; ``subsystem`` names it (ROADMAP.md, queue A)."""

    def __init__(self, subsystem: str, setting: str):
        super().__init__(
            f"{setting} selects {subsystem}, which rafiki_tpu_torch does not "
            "have yet (ROADMAP.md, queue A); unset it")
        self.subsystem = subsystem
        self.setting = setting


def _is_one(value: str) -> bool:
    return value == "1"


#: (environment name, whether a value selects a missing subsystem, its
#: name)
_UNPORTED = (
    ("RAFIKI_INSTALL_DEPS", _is_one, "dependency provisioning"),
)


def refuse_unported() -> None:
    """Raise :class:`NotPortedError` for the first setting in the
    environment that selects a subsystem the port lacks."""
    for name, selects, subsystem in _UNPORTED:
        value = os.environ.get(name, "").strip()
        if value and selects(value):
            raise NotPortedError(subsystem, f"{name}={value}")
    spec = os.environ.get("RAFIKI_CHAOS", "").strip()
    if spec:
        from rafiki_tpu_torch.utils import chaos

        try:
            chaos.parse_rules(spec)  # a rule at an unhooked site raises
        except chaos.ChaosSpecError:
            pass  # unparseable: logged and ignored where it is read
