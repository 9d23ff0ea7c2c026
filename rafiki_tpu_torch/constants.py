"""Framework-wide enums, as plain string-valued classes.

Own copy of ``rafiki_tpu/constants.py``, with the same string values, so
the rows and JSON answers of the two packages read alike. Kept: user
types, budget keys, task types, and the job, trial and service status
machines, the rollout and drift loop phases, and a host agent's health.
"""


class UserType:
    SUPERADMIN = "SUPERADMIN"
    ADMIN = "ADMIN"
    MODEL_DEVELOPER = "MODEL_DEVELOPER"
    APP_DEVELOPER = "APP_DEVELOPER"


class BudgetType:
    #: trials per model
    MODEL_TRIAL_COUNT = "MODEL_TRIAL_COUNT"
    #: cards for a train job (the JAX package's chips)
    CHIP_COUNT = "CHIP_COUNT"
    #: accepted alias of CHIP_COUNT
    GPU_COUNT = "GPU_COUNT"
    #: wall-clock budget of a train job, in hours
    TIME_HOURS = "TIME_HOURS"
    #: cards granted to each trial executor
    CHIPS_PER_TRIAL = "CHIPS_PER_TRIAL"
    EARLY_STOP = "EARLY_STOP"
    ASHA_MIN_EPOCHS = "ASHA_MIN_EPOCHS"
    ASHA_ETA = "ASHA_ETA"
    #: per-trial wall-clock cap in seconds
    TRIAL_TIMEOUT_S = "TRIAL_TIMEOUT_S"
    TRIAL_VMAP_K = "TRIAL_VMAP_K"
    #: cards granted to each inference worker
    CHIPS_PER_WORKER = "CHIPS_PER_WORKER"
    #: one worker holding every best trial
    ENSEMBLE_FUSED = "ENSEMBLE_FUSED"
    GEN_DRAFT_TRIAL = "GEN_DRAFT_TRIAL"


class TaskType:
    IMAGE_CLASSIFICATION = "IMAGE_CLASSIFICATION"
    POS_TAGGING = "POS_TAGGING"
    IMAGE_GENERATION = "IMAGE_GENERATION"
    TEXT_CLASSIFICATION = "TEXT_CLASSIFICATION"
    TEXT_GENERATION = "TEXT_GENERATION"


class TrainJobStatus:
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class TrialStatus:
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ERRORED = "ERRORED"
    TERMINATED = "TERMINATED"


class InferenceJobStatus:
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class ServiceStatus:
    STARTED = "STARTED"
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class ServiceType:
    TRAIN = "TRAIN"
    INFERENCE = "INFERENCE"
    PREDICT = "PREDICT"
    ADVISOR = "ADVISOR"


class RolloutPhase:
    """A live rollout's phases (admin/rollout.py): CANARY and ROLLING are
    live (one a job at most), the other three terminal; ABORTED ended
    without a rollback pass (the job stopped, the admin shut down, a stale
    row was swept)."""

    CANARY = "CANARY"
    ROLLING = "ROLLING"
    DONE = "DONE"
    ROLLED_BACK = "ROLLED_BACK"
    ABORTED = "ABORTED"

    LIVE = (CANARY, ROLLING)
    TERMINAL = (DONE, ROLLED_BACK, ABORTED)


class DriftPhase:
    """The drift loop's phases, one row an inference job
    (admin/drift.py): WATCHING a frozen baseline; RETRAINING, one bounded
    warm-started retrain in flight (its id is the idempotency key);
    ROLLING_OUT a better candidate through the judged rollout; COOLDOWN
    until ``cooldown_until``; PARKED until an operator's ack.
    RETRAINING and ROLLING_OUT are the live phases a restarted admin
    resumes."""

    WATCHING = "WATCHING"
    RETRAINING = "RETRAINING"
    ROLLING_OUT = "ROLLING_OUT"
    COOLDOWN = "COOLDOWN"
    PARKED = "PARKED"

    LIVE = (RETRAINING, ROLLING_OUT)


class ModelAccessRight:
    PUBLIC = "PUBLIC"
    PRIVATE = "PRIVATE"


class AgentHealth:
    """A host agent's heartbeat state (``placement/hosts.py``); UNKNOWN
    until its first probe."""
    UNKNOWN = "UNKNOWN"
    UP = "UP"
    DOWN = "DOWN"
