"""Deterministic fault injection: make failures happen on demand.

The port of ``lfm_quant_tpu/utils/faults.py`` (the spec grammar, the
schedules and the kinds are the JAX package's). Named injection points
(the *fault sites* below) call :func:`check` on their hot path, and an
``LFM_FAULTS`` spec string turns specific calls at specific sites into
seeded, schedulable failures: a dispatch failure, a failed H2D or a
failed lease, on demand and reproducibly, in a unit test or on the card.

Fault sites wired in the port:

* ``serve_dispatch`` — the micro-batcher's scoring dispatch, before each
  attempt (serve/batcher.py), the site the retry + circuit-breaker
  layer guards;
* ``panel_h2d``      — the device-panel transfer (train/loop.py
  ``Predictor``: the packed panel moved to the device);
* ``zoo_lease``      — taking a serving lease on a zoo entry
  (serve/zoo.py ``ModelZoo.lease``);
* ``ckpt_write``     — each checkpoint save (train/checkpoint.py
  ``CheckpointManager.save``), where the preemption tests schedule
  their ``sigterm``;
* ``device_get``     — the epoch's one counted device→host fetch
  (train/pipeline.py ``Fetch.wait``);
* ``zoo_persist``    — a durable publish, after its journal ``begin``
  and before any artifact is staged (serve/persist.py
  ``ZooStore.record_publish``);
* ``manifest_write`` — the publish's commit point, checked just before
  (even call index) and just after (odd) the manifest's atomic rename
  (``ZooStore._commit_manifest``), where the crash tests deliver their
  ``sigkill``.

Spec grammar (``LFM_FAULTS``)::

    site:key=val[,key=val...][;site2:...]

    kind=transient|permanent|sigterm|sigkill   (default transient)
    at=I[+J+...]   fire on exactly these 0-based call indices
    p=F            else fire per call with probability F (seeded RNG)
    seed=N         the p-mode RNG seed (default 0)
    n=N            cap total injections at N (p-mode/every-call bound)

With neither ``at`` nor ``p`` the site fires on EVERY call (bounded by
``n``). Examples: ``serve_dispatch:n=3`` (first three dispatches fail
transiently), ``ckpt_write:at=2,kind=sigterm`` (deliver SIGTERM to self
at the third checkpoint write — the kill-mid-epoch preemption test),
``panel_h2d:p=0.2,seed=7,kind=permanent``.

Kinds: ``transient`` raises :class:`TransientFault` (the retry layer's
"worth retrying" classification — serve/errors.py ``is_transient``),
``permanent`` raises :class:`PermanentFault` (fail fast, trip the
breaker), ``sigterm`` delivers SIGTERM to the current process at the
site and returns, ``sigkill`` delivers SIGKILL (the process dies at the
site).

Determinism: each site keeps a call counter and (for ``p``) a private
``random.Random(seed)``; given the same call order, two runs inject the
identical schedule. Counters are lock-guarded, so concurrent callers
(the serving threads) each consume distinct call indices; cross-thread
interleaving order is the only nondeterminism, exactly as for the real
failures being modeled.

Non-interference: with ``LFM_FAULTS`` unset, :func:`check` is one
module-global read plus a None test — no lock, no env read after the
first call, no telemetry, no device work (tests/test_torch_serve_stack.py
holds the served scores and the kernel launch counts equal with the
layer unset). Every injection bumps ``faults_injected`` /
``fault_<site>`` in the telemetry counter registry and emits a
``fault_injected`` instant.
"""

from __future__ import annotations

import os
import random
import signal
import threading
from typing import Any, Dict, Optional

#: The named injection points (the only valid spec sites — a typo'd
#: site must fail loudly, not silently never fire).
SITES = ("serve_dispatch", "panel_h2d", "zoo_lease", "ckpt_write",
         "device_get", "zoo_persist", "manifest_write")

#: The supported failure kinds.
KINDS = ("transient", "permanent", "sigterm", "sigkill")


class FaultError(RuntimeError):
    """Base class of injected failures. ``transient`` is the retry
    layer's classification hook (serve/errors.py ``is_transient``)."""

    transient = False

    def __init__(self, site: str, call: int):
        super().__init__(
            f"injected {type(self).__name__} at fault site {site!r} "
            f"(call #{call}, LFM_FAULTS)")
        self.site = site
        self.call = call


class TransientFault(FaultError):
    """An injected failure the caller SHOULD retry (a flaky dispatch,
    a dropped tunnel packet)."""

    transient = True


class PermanentFault(FaultError):
    """An injected failure retrying cannot fix (a poisoned program, a
    corrupt panel) — the circuit breaker's food."""


class _SitePlan:
    """One site's parsed schedule. ``fire`` is called under the module
    lock: it consumes one call index and returns it when the call
    should fail (None otherwise)."""

    __slots__ = ("site", "kind", "prob", "at", "limit", "rng", "calls",
                 "injected")

    def __init__(self, site: str, kind: str, prob: Optional[float],
                 at: Optional[frozenset], limit: Optional[int], seed: int):
        self.site = site
        self.kind = kind
        self.prob = prob
        self.at = at
        self.limit = limit
        self.rng = random.Random(seed)
        self.calls = 0
        self.injected = 0

    def fire(self) -> Optional[int]:
        idx = self.calls
        self.calls += 1
        if self.limit is not None and self.injected >= self.limit:
            return None
        if self.at is not None:
            hit = idx in self.at
        elif self.prob is not None:
            # Drawn once per call regardless of outcome, so the schedule
            # is a pure function of (seed, call index).
            hit = self.rng.random() < self.prob
        else:
            hit = True
        if not hit:
            return None
        self.injected += 1
        return idx


def parse_spec(spec: str) -> Dict[str, _SitePlan]:
    """Parse an ``LFM_FAULTS`` spec into per-site plans. Loud on any
    unknown site/kind/key — a chaos experiment that silently never
    fires is worse than no experiment."""
    plans: Dict[str, _SitePlan] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, sep, body = part.partition(":")
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"LFM_FAULTS: unknown fault site {site!r} "
                f"(valid: {', '.join(SITES)})")
        if site in plans:
            raise ValueError(f"LFM_FAULTS: duplicate site {site!r}")
        kind, prob, at, limit, seed = "transient", None, None, None, 0
        if sep:
            for kv in body.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                key, sep2, val = kv.partition("=")
                if not sep2:
                    raise ValueError(
                        f"LFM_FAULTS: {site}: expected key=val, got {kv!r}")
                key = key.strip()
                val = val.strip()
                try:
                    if key == "kind":
                        if val not in KINDS:
                            raise ValueError(
                                f"kind must be one of {KINDS}, got {val!r}")
                        kind = val
                    elif key == "p":
                        prob = float(val)
                        if not 0.0 <= prob <= 1.0:
                            raise ValueError(f"p must be in [0, 1], got {prob}")
                    elif key == "at":
                        at = frozenset(int(tok) for tok in val.split("+"))
                    elif key == "n":
                        limit = int(val)
                    elif key == "seed":
                        seed = int(val)
                    else:
                        raise ValueError(f"unknown key {key!r} "
                                         "(kind|p|at|n|seed)")
                except ValueError as e:
                    raise ValueError(f"LFM_FAULTS: {site}: {e}") from None
        plans[site] = _SitePlan(site, kind, prob, at, limit, seed)
    return plans


#: Sentinel: spec not yet resolved — the first :func:`check`/:func:`active`
#: reads the env exactly once. ``None`` means "no faults configured".
_UNSET = object()
_PLANS: Any = _UNSET
_LOCK = threading.Lock()


def configure(spec: Optional[str] = None) -> Optional[Dict[str, _SitePlan]]:
    """(Re)configure the fault schedules. ``spec=None`` re-reads the
    ``LFM_FAULTS`` env knob (what tests that monkeypatch the env call);
    an explicit string configures directly (``""`` disables). Returns
    the active plans dict, or None when no faults are configured.
    Every configure RESETS call counters — schedules restart."""
    global _PLANS
    if spec is None:
        spec = os.environ.get("LFM_FAULTS", "")
    plans = parse_spec(spec) if spec.strip() else None
    with _LOCK:
        _PLANS = plans
    return plans


def active() -> bool:
    """Whether any fault schedule is configured."""
    plans = _PLANS
    if plans is _UNSET:
        plans = configure()
    return bool(plans)


def check(site: str, **ctx) -> None:
    """The injection point every fault site calls. EXACT no-op when no
    spec is configured (one global read + a None test); with a schedule
    hit it bumps the fault counters, emits a ``fault_injected``
    telemetry instant (``ctx`` lands in the instant's args) and raises
    the scheduled :class:`FaultError` — or delivers SIGTERM to the own
    process for ``kind=sigterm``."""
    plans = _PLANS
    if plans is _UNSET:
        plans = configure()
    if not plans:
        return
    plan = plans.get(site)
    if plan is None:
        return
    with _LOCK:
        idx = plan.fire()
    if idx is None:
        return
    from lfm_quant_tpu_torch.utils import telemetry

    telemetry.COUNTERS.bump("faults_injected")
    telemetry.COUNTERS.bump(f"fault_{site}")
    telemetry.instant("fault_injected", cat="fault", site=site,
                      kind=plan.kind, call=idx, **ctx)
    if plan.kind == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if plan.kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
        return  # unreachable: SIGKILL is not deliverable-later, it kills
    cls = TransientFault if plan.kind == "transient" else PermanentFault
    raise cls(site, idx)
