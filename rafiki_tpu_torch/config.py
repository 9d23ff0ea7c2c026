"""Settings, read from the same environment names with the same defaults
as ``rafiki_tpu/config.py``.

Paths, the settings a live deployment may retune
(``PREDICT_QUEUE_DEPTH``, the per-job doors ``PREDICTOR_PORTS`` and
``PREDICTOR_HOST``, the generation worker's ``GEN_*``) and the
wall-clock budgets (``PREDICT_TIMEOUT_S``, ``SERVICE_DEPLOY_TIMEOUT_S``)
are read at each use (module ``__getattr__``), so a test or an operator
can repoint ``RAFIKI_WORKDIR`` or give a loaded host longer budgets
without re-importing (the JAX package reads the two budgets once, at
import).
One default differs: the metadata store is
``WORKDIR/rafiki_torch.sqlite3``, so the two packages never open one
file with different schemas.

:func:`refuse_unported` turns the settings that would select a subsystem
the port does not have yet into a typed :class:`NotPortedError`.
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


def _positive(value: str) -> bool:
    try:
        return float(value) > 0
    except ValueError:
        return False


#: (environment name, whether a value selects a missing subsystem, its
#: name)
_UNPORTED = (
    ("RAFIKI_ADMIN_HA", _is_one, "control-plane HA (lease, standby)"),
    ("RAFIKI_PLACEMENT", lambda v: v == "hosts", "host placement (agents)"),
    ("RAFIKI_SANDBOX", _is_one, "the trial sandbox"),
    ("RAFIKI_INSTALL_DEPS", _is_one, "dependency provisioning"),
    ("RAFIKI_GEN_SPEC", _is_one, "speculative decoding"),
    ("RAFIKI_GEN_RESUME_MAX", _positive,
     "stream resume (the door's journal)"),
)


def refuse_unported() -> None:
    """Raise :class:`NotPortedError` for the first setting in the
    environment that selects a subsystem the port lacks."""
    for name, selects, subsystem in _UNPORTED:
        value = os.environ.get(name, "").strip()
        if value and selects(value):
            raise NotPortedError(subsystem, f"{name}={value}")
