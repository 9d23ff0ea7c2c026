"""Deterministic fault injection: the switchboard behind ``RAFIKI_CHAOS``.

Own copy of ``rafiki_tpu/utils/chaos.py``: the rule parser, the
controller (``install``, ``clear``, ``enabled``, ``hit``), ``sleep_for``
and the site and action names. Rules come from the ``RAFIKI_CHAOS``
environment variable (unset means every hook is a no-op) or from
:func:`install`. Env format: ``|``-separated rules of ``;``-separated
``key=value`` fields, e.g. ::

    RAFIKI_CHAOS='site=trial;action=error;times=1'

Fields: ``site`` and ``action`` (required), ``match`` (a substring of the
target; empty matches all), ``after`` (skip the first N matches),
``times`` (inject at most N times), ``every`` (every k-th match past
``after``), ``delay_s`` (for ``delay``, default 0.05) and ``code`` (HTTP
status for ``error``, default 503). A schedule depends only on the order
of the requests a rule has seen, never on randomness; the controller
re-parses ``RAFIKI_CHAOS`` whenever its value changes (counters reset
with it).

Eleven sites have their hooks in the port:

- ``trial`` (``worker/train.py``, one ask per trial attempt, target
  ``"{sub_train_job_id} {trial_id}"``): ``delay`` sleeps, ``oom`` raises
  a host ``MemoryError``, ``error`` a transient ``INFRA`` fault;
- ``worker`` (both serve loops, one ask a batch or a scheduler round,
  target ``"{inference_job_id}/{service_id}"``): ``delay`` sleeps; in
  the classification loop ``drop`` swallows the batch and ``error``
  fails it; in the generation loop ``drop`` is the SIGKILL drill (the
  replica leaves, its streams abandoned) and ``error`` a clean
  retirement (its streams handed back ``MIGRATING``);
- ``generate`` (``worker/generation.py``): at each slot a round, target
  ``"{job}/{service}/slot{i}/{seq_id}"`` (``drop`` mutes the stream,
  ``error`` fails it), and at the draft a speculative round, target
  ``"draft/{job}/{service}"`` (``drop`` skips speculation that round,
  ``error`` degrades it for good);
- ``deploy`` (``admin/services.py``, one ask each time a serving replica
  is placed: the initial deploy, a scale-up, a standby, a rollout's
  canary, rolling and restoring replicas; target
  ``"{inference_job_id}/{trial_id}"``): ``delay`` sleeps (a slow deploy),
  ``error`` and ``drop`` raise the typed deploy failure (the canary
  rollback drill);
- ``drift`` (``admin/drift.py``): at each job's monitor tick, target
  ``"tick/{inference_job_id}"`` (``delay`` sleeps, anything else fails
  that job's tick, which serving never sees), and at each retrain launch,
  target ``"launch/{inference_job_id}"`` (``delay`` sleeps, anything else
  fails the launch: bounded retries, then the loop parks);
- ``db`` (``db/database.py``, before every statement, target the SQL
  text): ``delay`` sleeps (a slow store), anything else raises the typed
  transient ``MetadataStoreChaosError`` (crash recovery retries it);
- ``lease`` (``db/database.py``, at the lease's acquisition and renewal,
  target ``acquire`` or ``renew``): ``delay`` sleeps (a slow store near
  the TTL's edge), anything else raises ``MetadataStoreChaosError`` (the
  false-lease-loss drill: a renewal error never demotes a leader);
- ``agent`` (``placement/agent.py``, each request a host agent takes,
  target its path): ``drop`` closes the connection unanswered (the
  caller sees a dead host), ``error`` answers ``code``, ``delay`` sleeps;
- ``call_agent`` (``utils/agent_http.py``, each attempt inside the retry
  loop, target ``"{addr} {path}"``): ``drop`` is a transport failure
  (retried when the call is idempotent, counted by the breaker),
  ``error`` an answer with ``code``, ``delay`` sleeps;
- ``wire`` (``cache/shm_broker.py``, each frame popped off an shm ring,
  the worker's query ring and the broker's response ring, before it is
  decoded; target the ring's name): ``corrupt`` truncates (odd hits) or
  garbles (even hits) the bytes, and the decoder drops the frame typed
  (its requests end at their deadline), never the loop;
- ``cache`` (``predictor/result_cache.py``, each lookup, fill and flight
  join, target ``"{inference_job_id}/{op}"``): ``delay`` sleeps, anything
  else raises ``CacheChaosError``, which the predictor absorbs into the
  miss path (a broken cache serves real forwards).

A rule naming any other site of the original raises
:class:`~rafiki_tpu_torch.config.NotPortedError` when it is made,
installed or read from the environment: it is never silently inert.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from rafiki_tpu_torch.config import NotPortedError

logger = logging.getLogger(__name__)

ENV_VAR = "RAFIKI_CHAOS"

SITE_CALL_AGENT = "call_agent"
SITE_AGENT = "agent"
SITE_WORKER = "worker"
SITE_WIRE = "wire"
SITE_DB = "db"
SITE_GENERATE = "generate"
SITE_DEPLOY = "deploy"
SITE_CACHE = "cache"
SITE_DRIFT = "drift"
#: the trial-run chokepoint (``TrainWorker._chaos_trial``)
SITE_TRIAL = "trial"
SITE_COMPILE = "compile"
SITE_LEASE = "lease"

#: every site the original knows
SITES = (SITE_CALL_AGENT, SITE_AGENT, SITE_WORKER, SITE_WIRE, SITE_DB,
         SITE_TRIAL, SITE_GENERATE, SITE_DEPLOY, SITE_CACHE, SITE_DRIFT,
         SITE_COMPILE, SITE_LEASE)
#: the sites whose hook the port has
HOOKED_SITES = (SITE_TRIAL, SITE_WORKER, SITE_GENERATE, SITE_DEPLOY,
                SITE_DRIFT, SITE_DB, SITE_LEASE, SITE_AGENT, SITE_CALL_AGENT,
                SITE_WIRE, SITE_CACHE)

ACTION_DROP = "drop"
ACTION_DELAY = "delay"
ACTION_ERROR = "error"
ACTION_CORRUPT = "corrupt"
ACTION_OOM = "oom"


class ChaosSpecError(ValueError):
    """``RAFIKI_CHAOS`` could not be parsed; raised at install, logged
    (once per bad value) when it comes from the environment."""


@dataclass
class ChaosRule:
    site: str
    action: str
    match: str = ""
    after: int = 0
    times: Optional[int] = None
    every: int = 1
    delay_s: float = 0.05
    code: int = 503
    hits: int = field(default=0, compare=False)  # matching requests seen

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ChaosSpecError(f"unknown chaos site {self.site!r}")
        if self.action not in (ACTION_DROP, ACTION_DELAY, ACTION_ERROR,
                               ACTION_CORRUPT, ACTION_OOM):
            raise ChaosSpecError(f"unknown chaos action {self.action!r}")
        if self.action == ACTION_CORRUPT and self.site not in (SITE_WIRE,
                                                               SITE_COMPILE):
            raise ChaosSpecError(
                "chaos action 'corrupt' only applies at site=wire (raw "
                "frame bytes) or site=compile (cache entries on disk)")
        if self.action == ACTION_OOM and self.site != SITE_TRIAL:
            raise ChaosSpecError(
                "chaos action 'oom' only applies at site=trial "
                "(trial-run chokepoint)")
        if self.every < 1:
            raise ChaosSpecError("chaos 'every' must be >= 1")
        if self.site not in HOOKED_SITES:
            raise NotPortedError(f"the chaos hook at site={self.site}",
                                 f"{ENV_VAR} site={self.site}")

    def fires(self, site: str, target: str) -> bool:
        """Count a request against this rule; True when the fault applies.
        Deterministic: depends only on the request order seen so far."""
        if site != self.site or self.match not in target:
            return False
        self.hits += 1
        n = self.hits - self.after  # 1-based index past the warm-up window
        if n <= 0:
            return False
        if self.times is not None and n > self.times * self.every:
            return False
        return (n - 1) % self.every == 0


def parse_rules(spec: str) -> List[ChaosRule]:
    rules: List[ChaosRule] = []
    for chunk in spec.split("|"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = {}
        for kv in chunk.split(";"):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ChaosSpecError(f"chaos field {kv!r} is not key=value")
            k, v = kv.split("=", 1)
            fields[k.strip()] = v.strip()
        unknown = set(fields) - {"site", "action", "match", "after",
                                 "times", "every", "delay_s", "code"}
        if unknown:
            raise ChaosSpecError(f"unknown chaos fields {sorted(unknown)}")
        try:
            rules.append(ChaosRule(
                site=fields.get("site", ""),
                action=fields.get("action", ""),
                match=fields.get("match", ""),
                after=int(fields.get("after", 0)),
                times=(int(fields["times"]) if "times" in fields else None),
                every=int(fields.get("every", 1)),
                delay_s=float(fields.get("delay_s", 0.05)),
                code=int(fields.get("code", 503)),
            ))
        except (TypeError, ValueError) as e:
            if isinstance(e, ChaosSpecError):
                raise
            raise ChaosSpecError(f"bad chaos rule {chunk!r}: {e}") from e
    return rules


class ChaosController:
    """Holds the active rule set; thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: List[ChaosRule] = []
        self._installed = False      # programmatic rules win over env
        self._env_value: Optional[str] = None
        self._env_bad: Optional[str] = None

    def install(self, rules: List[ChaosRule]) -> None:
        with self._lock:
            self._rules = list(rules)
            self._installed = True

    def clear(self) -> None:
        with self._lock:
            self._rules = []
            self._installed = False
            self._env_value = None
            self._env_bad = None

    def enabled(self) -> bool:
        with self._lock:
            self._refresh_env_locked()
            return bool(self._rules)

    def hit(self, site: str, target: str) -> Optional[ChaosRule]:
        """Record one request at ``site`` against every rule; return the
        first rule whose schedule fires, else None. Lock-free when chaos
        is provably off (no rules, env unset): a racing install or env
        change is picked up by the next call."""
        if (not self._installed and not self._rules and not self._env_value
                and not os.environ.get(ENV_VAR)):
            return None
        with self._lock:
            self._refresh_env_locked()
            for rule in self._rules:
                if rule.fires(site, target):
                    logger.warning("chaos %s@%s -> %s", site, target,
                                   rule.action)
                    return rule
        return None

    def _refresh_env_locked(self) -> None:  # guarded-by: _lock
        if self._installed:
            return
        value = os.environ.get(ENV_VAR, "")
        if value == self._env_value:
            return
        try:
            rules = parse_rules(value)
        except ChaosSpecError as e:
            self._env_value = value
            self._rules = []
            if value != self._env_bad:
                self._env_bad = value
                logger.error("ignoring unparseable %s: %s", ENV_VAR, e)
            return
        # a NotPortedError propagates, and the value stays unread: every
        # later ask raises it again
        self._env_value = value
        self._rules = rules
        self._env_bad = None


_controller = ChaosController()

install = _controller.install
clear = _controller.clear
enabled = _controller.enabled
hit = _controller.hit


def sleep_for(rule: ChaosRule) -> None:
    """Apply a delay rule (kept here so call sites stay one-liners)."""
    time.sleep(rule.delay_s)


def corrupt_bytes(raw: bytes, rule: ChaosRule) -> bytes:
    """Apply a ``site=wire`` ``corrupt`` rule to popped frame bytes:
    odd hits truncate (a partial write), even hits garble bytes in place,
    deterministic in the rule's hit count."""
    if not raw:
        return raw
    if rule.hits % 2:
        return raw[: max(len(raw) // 2, 1)]
    buf = bytearray(raw)
    for i in range(0, len(buf), max(len(buf) // 8, 1)):
        buf[i] ^= 0xA5
    return bytes(buf)
