"""FM tiers, the counterpart of ``src/repro/core/fm.py``: a weak or
strong foundation model behind a uniform serving facade, with per-call
cost accounting (the quantity RAR minimizes).

The tier wraps a trained model + the batched serving engine. Costs are
reported in FLOPs derived from the architecture config (6·N_active per
token), so heterogeneous tiers (an SSM edge model vs. a dense cloud model)
compare on one axis.

Tier-call resilience (the recovery plane's FM leg)
--------------------------------------------------
A production tier is a remote service that fails and browns out.
:class:`ResilientTier` wraps any tier object (an :class:`FMTier`, a test
fake — anything exposing the ``answer_*`` / ``generate_guides_*``
surface) with:

* **retry with exponential backoff + seeded jitter** around every call —
  only :class:`TransientTierError` s are retried; application exceptions
  propagate unchanged on the first raise;
* a **circuit breaker** (closed → open → half-open) that sheds calls
  during an outage instead of hammering a dead service. The controllers
  read ``breaker.available()`` as a *routing input*: while the strong
  tier's breaker is open they serve degraded (weak-only) and defer the
  suppressed shadow probes — see :func:`repro_torch.core.decisions.classify`;
* a **cooperative timeout**: a synchronous in-process call cannot be
  preempted, so ``timeout`` is enforced against *injected* latency
  spikes (the fault plan raises :class:`TierTimeout` instead of sleeping
  when a spike exceeds the budget) — which is exactly what the
  deterministic fault suite needs, with no real waiting.

The wrapper delegates every other attribute (``engine``, ``calls``,
``vocab``, …) to the inner tier via ``__getattr__``, and only advertises
``answer_many``/``generate_guides_many`` if the inner tier has them — so
capability probes like ``getattr(tier, "answer_many", None)`` keep
working through the wrapper.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np

from repro_torch.data import tokenizer as tk
from repro_torch.data.tokenizer import Vocab
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import ServingEngine


@dataclasses.dataclass
class FMTier:
    name: str
    cfg: ModelConfig
    engine: ServingEngine
    vocab: Vocab

    @classmethod
    def create(cls, name: str, cfg: ModelConfig, params: Any,
               vocab: Vocab) -> "FMTier":
        return cls(name=name, cfg=cfg, engine=ServingEngine(cfg, params),
                   vocab=vocab)

    # ------------------------------------------------------------------
    @property
    def calls(self) -> int:
        return self.engine.calls

    @property
    def flops_spent(self) -> float:
        return self.engine.flops_spent

    # ------------------------------------------------------------------
    def answer_batch(self, prompts: np.ndarray) -> np.ndarray:
        """prompts: (B, Lp) uniform-length question prompts ending in ANS.
        Returns (B,) answer indices in [0, 4) (-1 if the model emitted a
        non-option token)."""
        out = self.engine.generate({"tokens": np.asarray(prompts)},
                                   max_new=1).cpu().numpy()
        ans = out[:, 0] - tk.OPTION_A
        ans[(ans < 0) | (ans > 3)] = -1
        return ans

    def answer_many(self, prompts: list[np.ndarray]) -> np.ndarray:
        """Mixed-length variant of :meth:`answer_batch`: prompts may have
        different lengths; they are served through the engine's
        length-bucketed path in one logical sweep."""
        out = self.engine.generate_bucketed(prompts, max_new=1)
        ans = out[:, 0] - tk.OPTION_A
        ans[(ans < 0) | (ans > 3)] = -1
        return ans

    def generate_guides(self, requests: np.ndarray,
                        guide_len: int) -> np.ndarray:
        """requests: (B, Lr) guide-request prompts. Returns (B, guide_len)
        guide token blocks: [GUIDE_START, hints..., GUIDE_END, PAD...]."""
        hints = self.engine.generate({"tokens": np.asarray(requests)},
                                     max_new=2).cpu().numpy()
        return self._pack_guides(hints, guide_len)

    def generate_guides_many(self, requests: list[np.ndarray],
                             guide_len: int) -> np.ndarray:
        """Mixed-length variant of :meth:`generate_guides`."""
        hints = self.engine.generate_bucketed(requests, max_new=2)
        return self._pack_guides(hints, guide_len)

    @staticmethod
    def _pack_guides(hints: np.ndarray, guide_len: int) -> np.ndarray:
        B = hints.shape[0]
        guides = np.full((B, guide_len), tk.PAD, np.int32)
        guides[:, 0] = tk.GUIDE_START
        guides[:, 1:3] = hints
        guides[:, 3] = tk.GUIDE_END
        return guides


# ---------------------------------------------------------------------------
# Tier-call resilience: exception taxonomy, retry policy, circuit breaker
# ---------------------------------------------------------------------------


class TierError(RuntimeError):
    """Base of the tier-call failure taxonomy."""


class TransientTierError(TierError):
    """A retryable failure (network blip, injected fault). Only this
    family is retried by :class:`ResilientTier`; anything else is an
    application error and propagates on the first raise."""


class TierTimeout(TransientTierError):
    """The (cooperative) call timeout was exceeded."""


class InjectedTierError(TransientTierError):
    """A transient failure injected by a fault plan's ``tier_call`` spec
    (``repro.serving.faults.FaultPlan`` in the JAX package)."""


class TierUnavailableError(TierError):
    """The tier is down *right now*: either its circuit breaker shed the
    call, or retries were exhausted. The controllers catch exactly this
    to enter degraded (weak-only) routing."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for :class:`ResilientTier` (all off by default: 0 retries,
    no timeout, no breaker — a pass-through wrapper)."""
    max_retries: int = 0
    timeout: float | None = None      # cooperative — see module docstring
    backoff_base: float = 0.02        # first retry sleep, doubled per try
    backoff_max: float = 1.0
    jitter: bool = True               # scale each sleep by U[0.5, 1.5)
    breaker_threshold: int = 0        # consecutive failures to open; 0=off
    breaker_cooldown: float = 1.0     # seconds open before a half-open probe
    breaker_adaptive: bool = False    # EWMA-driven threshold/cooldown
    breaker_ewma_alpha: float = 0.2   # error-rate EWMA smoothing


class CircuitBreaker:
    """closed → open → half-open breaker over one tier's call stream.

    * **closed** — calls pass; ``threshold`` *consecutive* failures open
      the breaker.
    * **open** — calls are shed (:class:`TierUnavailableError`) until
      ``cooldown`` seconds have passed.
    * **half-open** — one probe call is let through; success closes the
      breaker, failure re-opens it (fresh cooldown). Concurrent calls
      during the probe are shed.

    ``now_fn`` is injectable (default ``time.monotonic``) so tests drive
    the cooldown with a fake clock. ``available()`` is the non-mutating
    peek the routing layer uses: True unless open and still cooling
    down — an elapsed cooldown reads as available because the very next
    call is the half-open probe.

    With ``adaptive=True`` the breaker derives its *effective* knobs
    from an EWMA of observed per-call error rates (1 = failure,
    0 = success, smoothing ``ewma_alpha``): a tier observed to be flaky
    opens after fewer consecutive failures
    (``max(1, round(threshold · (1 − ewma)))``) and cools down longer
    (``cooldown · (1 + ewma)``); a tier with a clean history keeps the
    configured knobs exactly. Default OFF — with ``adaptive=False`` the
    arithmetic never runs and every byte-identity pin over the static
    breaker holds unchanged.
    """

    def __init__(self, threshold: int, cooldown: float,
                 now_fn=time.monotonic, *, adaptive: bool = False,
                 ewma_alpha: float = 0.2):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, "
                             f"got {threshold}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"breaker ewma_alpha must be in (0, 1], "
                             f"got {ewma_alpha}")
        self.threshold = threshold
        self.cooldown = cooldown
        self.adaptive = adaptive
        self.ewma_alpha = ewma_alpha
        self.error_ewma = 0.0
        self._now = now_fn
        self._lock = threading.Lock()
        self.state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.opens = 0               # times the breaker tripped open
        self.shed = 0                # calls rejected while open/probing
        self.transitions = 0         # state changes (closed/open/half_open)

    # -- adaptive knobs (locked callers only) ---------------------------
    def _effective_threshold_locked(self) -> int:
        if not self.adaptive:
            return self.threshold
        return max(1, round(self.threshold * (1.0 - self.error_ewma)))

    def _effective_cooldown_locked(self) -> float:
        if not self.adaptive:
            return self.cooldown
        return self.cooldown * (1.0 + self.error_ewma)

    def _observe_locked(self, failed: bool) -> None:
        if self.adaptive:
            a = self.ewma_alpha
            self.error_ewma += a * (float(failed) - self.error_ewma)

    def available(self) -> bool:
        """Non-mutating routing peek: would a call be allowed now?"""
        with self._lock:
            if self.state != "open":
                return True
            return self._now() - self._opened_at >= \
                self._effective_cooldown_locked()

    def before_call(self) -> None:
        """Gate one call; raises :class:`TierUnavailableError` to shed."""
        with self._lock:
            if self.state == "open":
                if self._now() - self._opened_at < \
                        self._effective_cooldown_locked():
                    self.shed += 1
                    raise TierUnavailableError(
                        "circuit breaker open (cooling down)")
                self.state = "half_open"
                self.transitions += 1
                self._probing = True
                return
            if self.state == "half_open":
                if self._probing:
                    self.shed += 1
                    raise TierUnavailableError(
                        "circuit breaker half-open (probe in flight)")
                self._probing = True

    def record_success(self) -> None:
        with self._lock:
            self._observe_locked(failed=False)
            if self.state != "closed":
                self.transitions += 1
            self.state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._observe_locked(failed=True)
            self._probing = False
            if self.state == "half_open":
                self._trip_locked()
                return
            self._failures += 1
            if self._failures >= self._effective_threshold_locked():
                self._trip_locked()

    def trip(self) -> None:
        """Force the breaker open (brownout drills / benchmarks)."""
        with self._lock:
            self._trip_locked()

    def _trip_locked(self) -> None:
        if self.state != "open":
            self.transitions += 1
        self.state = "open"
        self._opened_at = self._now()
        self._failures = 0
        self._probing = False
        self.opens += 1

    def stats(self) -> dict:
        with self._lock:
            out = {"state": self.state, "opens": self.opens,
                   "shed": self.shed, "transitions": self.transitions}
            if self.adaptive:
                out["error_ewma"] = self.error_ewma
                out["effective_threshold"] = \
                    self._effective_threshold_locked()
                out["effective_cooldown"] = \
                    self._effective_cooldown_locked()
            return out

    # -- crash-recovery manifest hooks ----------------------------------
    def export_state(self) -> dict:
        """Host-side snapshot for the recovery manifest. ``opened_at``
        is monotonic-clock-relative and meaningless across a process
        boundary, so an open breaker is exported as *remaining* cooldown
        semantics: restore re-opens it with a fresh cooldown (the
        conservative choice — a recovering site re-probes no sooner than
        the dead one would have)."""
        with self._lock:
            return {"state": self.state, "failures": self._failures,
                    "opens": self.opens, "shed": self.shed,
                    "transitions": self.transitions,
                    "error_ewma": self.error_ewma}

    def restore_state(self, st: dict) -> None:
        with self._lock:
            self.state = st["state"]
            self._failures = st["failures"]
            self.opens = st["opens"]
            self.shed = st["shed"]
            self.transitions = st.get("transitions", 0)
            self.error_ewma = st.get("error_ewma", 0.0)
            self._probing = False
            if self.state == "open":
                self._opened_at = self._now()   # fresh cooldown


#: tier surface methods routed through the retry/breaker path; everything
#: else delegates straight to the inner tier
_WRAPPED = ("answer_batch", "answer_many", "generate_guides",
            "generate_guides_many")


class ResilientTier:
    """Retry/breaker wrapper over any tier object (see module docstring).

    With the default :class:`RetryPolicy` this is a pure pass-through:
    same calls, same exceptions, same counters — the byte-identity pins
    hold with the wrapper installed. Wrapping is idempotent-by-check at
    the call sites (``isinstance(tier, ResilientTier)``), so a fabric
    that shares one wrapper (and one breaker) across replicas composes
    with controllers that also know how to wrap.
    """

    def __init__(self, tier, policy: RetryPolicy | None = None, *,
                 name: str | None = None, fault_plan=None, seed: int = 0,
                 sleep_fn=time.sleep, now_fn=time.monotonic):
        self.inner = tier
        self.policy = policy if policy is not None else RetryPolicy()
        self.name = name if name is not None else \
            getattr(tier, "name", "tier")
        self.fault_plan = fault_plan
        self.breaker = CircuitBreaker(
            self.policy.breaker_threshold, self.policy.breaker_cooldown,
            now_fn=now_fn, adaptive=self.policy.breaker_adaptive,
            ewma_alpha=self.policy.breaker_ewma_alpha) \
            if self.policy.breaker_threshold > 0 else None
        self._sleep = sleep_fn
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.retries = 0             # retry attempts actually made
        self.failures = 0            # transient failures observed
        self.shed_calls = 0          # calls shed by the breaker
        self.sleeps: list[float] = []  # backoff sleeps, in order (tests)

    def __getattr__(self, attr):
        # only reached when normal lookup fails → delegate to the inner
        # tier. getattr() raising AttributeError here is load-bearing:
        # capability probes (``getattr(tier, "answer_many", None)``) must
        # see exactly the inner tier's surface.
        inner = object.__getattribute__(self, "inner")
        val = getattr(inner, attr)
        if attr in _WRAPPED:
            def call(*args, **kw):
                return self._call(attr, val, *args, **kw)
            call.__name__ = attr
            return call
        return val

    def _call(self, op: str, fn, *args, **kw):
        policy = self.policy
        attempts = policy.max_retries + 1
        delay = policy.backoff_base
        for attempt in range(attempts):
            if self.breaker is not None:
                try:
                    self.breaker.before_call()
                except TierUnavailableError:
                    with self._lock:
                        self.shed_calls += 1
                    raise
            try:
                if self.fault_plan is not None:
                    self.fault_plan.fire("tier_call",
                                         timeout=policy.timeout,
                                         tier=self.name, op=op)
                out = fn(*args, **kw)
            except TransientTierError as err:
                with self._lock:
                    self.failures += 1
                if self.breaker is not None:
                    self.breaker.record_failure()
                if attempt + 1 >= attempts:
                    raise TierUnavailableError(
                        f"tier {self.name!r} {op} failed after "
                        f"{attempts} attempt(s)") from err
                sleep = min(delay, policy.backoff_max)
                if policy.jitter:
                    sleep *= 0.5 + self._rng.random()
                with self._lock:
                    self.retries += 1
                    self.sleeps.append(sleep)
                self._sleep(sleep)
                delay *= 2
            else:
                if self.breaker is not None:
                    self.breaker.record_success()
                return out

    def stats(self) -> dict:
        with self._lock:
            out = {"retries": self.retries, "failures": self.failures,
                   "shed_calls": self.shed_calls}
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        return out

    # -- crash-recovery manifest hooks ----------------------------------
    def export_state(self) -> dict:
        with self._lock:
            out = {"retries": self.retries, "failures": self.failures,
                   "shed_calls": self.shed_calls}
        if self.breaker is not None:
            out["breaker"] = self.breaker.export_state()
        return out

    def restore_state(self, st: dict) -> None:
        with self._lock:
            self.retries = st["retries"]
            self.failures = st["failures"]
            self.shed_calls = st["shed_calls"]
        if self.breaker is not None and st.get("breaker") is not None:
            self.breaker.restore_state(st["breaker"])
