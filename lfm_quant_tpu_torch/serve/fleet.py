"""Fleet serving: a coordinator over members, failover routing,
store-bootstrapped join.

Port of ``lfm_quant_tpu/serve/fleet.py``. A dead serving process is a
total outage; this module runs N members behind one router:

* **The coordinator** (:class:`FleetCoordinator`) owns what the members
  share: the member registry, the consistent (universe, generation) →
  member routing (rendezvous hashing, ``LFM_FLEET_REPLICAS``-way
  replication, per-universe overrides) and the publish FENCE, the
  durable store's committed generation per universe. Each member stays a
  whole :class:`~lfm_quant_tpu_torch.serve.service.ScoringService` with
  its own zoo and device panels; the single-process deploy is the
  degenerate one-member fleet (:meth:`FleetCoordinator.local`).
* **Failover routing** (:class:`FleetRouter`): each member's health
  surface (breaker state, readiness and retry-after, SLO burn) read
  through a TTL-cached probe; OUT members skipped, burning ones
  deprioritized; a failed call retried on the next replica with the
  batcher's capped jittered backoff (``LFM_FLEET_RETRIES``); an OUT
  member readmitted only through a half-open probe after
  ``LFM_FLEET_COOLDOWN_MS``. Every member restored from the same store
  serves bitwise-equal scores (the store's probe is the promotion
  criterion), so a failover response is the bytes the dead member would
  have sent; float32 → JSON → float32 is exact.
* **Store-bootstrapped join**: a member starts from the store alone
  (:func:`member_main`: restore, verify, serve) and
  :meth:`FleetCoordinator.add_member` is the gate: its restore report
  must be ``bit_equal``, its generations at the fence (one ``sync`` to
  catch up), and the store's probe month scored through it bitwise
  equal to the probe. A refused member is never routed to. A publish
  reaches every member through the fence
  (:meth:`FleetCoordinator.sync_members`, a member's ``/sync``).

Members are subprocesses (``python -m lfm_quant_tpu_torch.serve.fleet``,
started by :func:`spawn_member` with ``subprocess.Popen``, never by
forking a process that holds a CUDA context), each with its own CUDA
context on the card unless started with ``--device cpu``. With
``LFM_FLEET`` unset nothing here runs.

Observability: the router bumps ``fleet_requests`` / ``fleet_reroutes``
/ ``fleet_failovers`` / ``fleet_member_out`` / ``fleet_probes`` /
``fleet_readmissions`` / ``fleet_joins`` / ``fleet_refusals`` /
``fleet_unroutable`` and emits the matching ``fleet_*`` instants (the
per-member health timeline ``scripts/trace_report.py`` renders); the
fleet ``/metrics`` is the router's registry plus every remote member's
scrape relabelled ``member="name"``, and the fleet ``/healthz`` one
health probe per member.
"""

from __future__ import annotations

import json
import os
import threading
import time
from hashlib import sha256
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from lfm_quant_tpu_torch.serve.batcher import (
    ScoreResponse,
    backoff_sleep,
    clean_request_id,
    new_request_id,
)
from lfm_quant_tpu_torch.serve.errors import (
    DeadlineError,
    DriftVetoError,
    MemberUnavailableError,
)
from lfm_quant_tpu_torch.utils import telemetry

# ---- knobs (LFM_FLEET_*) --------------------------------------------------


def fleet_members_default() -> int:
    """``LFM_FLEET``: the member count of ``python -m
    lfm_quant_tpu_torch.serve``'s fleet mode (unset/0: one process, no
    router, no coordinator, no subprocesses)."""
    try:
        return max(0, int(os.environ.get("LFM_FLEET", "0")))
    except ValueError:
        raise ValueError(
            f"LFM_FLEET must be an integer member count, got "
            f"{os.environ.get('LFM_FLEET')!r}")


def fleet_enabled() -> bool:
    """Whether fleet serving is configured (the manifest knob probe)."""
    return fleet_members_default() > 0


def replicas_default() -> int:
    """``LFM_FLEET_REPLICAS``: how many members serve each universe
    (default 2, capped at the member count)."""
    return max(1, int(os.environ.get("LFM_FLEET_REPLICAS", "2")))


def retries_default() -> int:
    """``LFM_FLEET_RETRIES``: further members a request may fail over to
    after its first attempt (default 2)."""
    return max(0, int(os.environ.get("LFM_FLEET_RETRIES", "2")))


def breaker_default() -> int:
    """``LFM_FLEET_BREAKER``: consecutive failed calls that take a member
    OUT of the routing set (default 2)."""
    return max(1, int(os.environ.get("LFM_FLEET_BREAKER", "2")))


def cooldown_ms_default() -> float:
    """``LFM_FLEET_COOLDOWN_MS``: how long an OUT member is skipped
    before the half-open probe (default 1000 ms; a longer
    ``retry_after_s`` from its /healthz wins)."""
    return max(0.0, float(os.environ.get("LFM_FLEET_COOLDOWN_MS", "1000")))


def health_ttl_ms_default() -> float:
    """``LFM_FLEET_HEALTH_TTL_MS``: how long a member's health probe is
    trusted (default 500 ms)."""
    return max(0.0, float(os.environ.get("LFM_FLEET_HEALTH_TTL_MS", "500")))


def member_timeout_ms_default() -> float:
    """``LFM_FLEET_TIMEOUT_MS``: the per-member call timeout (default
    15000 ms; the client's own deadline caps it per attempt)."""
    return max(1.0, float(os.environ.get("LFM_FLEET_TIMEOUT_MS", "15000")))


# ---- member-level failure taxonomy ---------------------------------------


class MemberCallError(RuntimeError):
    """A member-level failure of one call: connection refused or reset,
    timeout, an HTTP 5xx/429 from its front door. ``transient``: another
    replica can serve the same request (serve/errors.py
    ``is_transient`` reads the attribute)."""

    transient = True

    def __init__(self, member: str, detail: str,
                 status: Optional[int] = None):
        super().__init__(f"member {member!r}: {detail}")
        self.member = member
        self.status = status


def member_retryable(exc: BaseException) -> bool:
    """May another member serve this request? Not for client or data
    errors that fail identically everywhere (unknown universe or month,
    malformed values, an expired deadline, a drift veto); yes for every
    other failure (shed, open circuit, dead batcher, transient faults,
    connection failures), since every member serves the same store
    bitwise."""
    if isinstance(exc, (KeyError, ValueError, TypeError,
                        DeadlineError, DriftVetoError)):
        return False
    return True


# ---- member adapters ------------------------------------------------------


class LocalMember:
    """An in-process :class:`ScoringService` as a member: the one-member
    fleet, and the unit-test vehicle of the routing machinery."""

    remote = False

    def __init__(self, name: str, service: Any):
        self.name = name
        self.service = service

    def score(self, universe: str, month: int,
              timeout_s: Optional[float] = None,
              request_id: Optional[str] = None) -> ScoreResponse:
        return self.service.score(universe, month, timeout=timeout_s,
                                  request_id=request_id)

    def health(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        return self.service.health()

    def snapshot(self) -> Dict[str, Any]:
        return self.service.snapshot()

    def metrics_text(self) -> str:
        return self.service.metrics_text()

    def universes(self) -> Dict[str, int]:
        return dict(self.service.zoo.snapshot()["universes"])

    def serveable_months(self, universe: str) -> List[int]:
        return self.service.serveable_months(universe)

    def sync(self) -> List[Dict[str, Any]]:
        return self.service.sync_from_store()

    def join_report(self) -> Dict[str, Any]:
        return join_report(self.service, member=self.name)

    def close(self) -> None:
        self.service.close()


def join_report(service: Any, **extra) -> Dict[str, Any]:
    """What a member tells the join gate: identity, served generations,
    serveable months, restore verdicts and their counted cost (the
    ``/fleet`` answer of a single-process front door)."""
    universes = dict(service.zoo.snapshot()["universes"])
    rep = {
        "build": telemetry.build_info(),
        "universes": universes,
        "months": {u: service.serveable_months(u) for u in universes},
        "restore": getattr(service, "last_restore", None),
        "restore_compiles": getattr(service, "last_restore_compiles", None),
        "restore_panel_h2d": getattr(service, "last_restore_panel_h2d",
                                     None),
    }
    rep.update(extra)
    return rep


class HttpMember:
    """A subprocess (or remote) member reached over its HTTP front door
    (serve/http.py, the one front door of every deploy shape). Failures
    of the wire or of the member's degradation layer surface as
    :class:`MemberCallError` (the router fails over); a 404 surfaces as
    ``KeyError`` (the client's error on every member)."""

    remote = True

    def __init__(self, name: str, base_url: str,
                 timeout_s: Optional[float] = None,
                 pid: Optional[int] = None):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.timeout_s = (member_timeout_ms_default() / 1e3
                          if timeout_s is None else float(timeout_s))
        self.pid = pid
        self._months: Dict[str, List[int]] = {}

    def _get(self, path: str, timeout_s: Optional[float] = None,
             headers: Optional[Dict[str, str]] = None
             ) -> Tuple[int, bytes]:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base_url + path,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            # The member answered with a failure status: its body
            # carries the error taxonomy.
            return e.code, e.read()
        except Exception as e:  # noqa: BLE001 — wire-level failure
            raise MemberCallError(
                self.name, f"{type(e).__name__}: {e}") from e

    def _get_json(self, path: str, timeout_s: Optional[float] = None,
                  headers: Optional[Dict[str, str]] = None
                  ) -> Tuple[int, Any]:
        status, body = self._get(path, timeout_s, headers)
        try:
            return status, json.loads(body.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise MemberCallError(
                self.name, f"unparseable response ({e}) on {path}",
                status=status) from e

    def score(self, universe: str, month: int,
              timeout_s: Optional[float] = None,
              request_id: Optional[str] = None) -> ScoreResponse:
        headers = {"X-Request-Id": request_id} if request_id else {}
        status, payload = self._get_json(
            f"/score?universe={universe}&month={int(month)}",
            timeout_s=timeout_s, headers=headers)
        if status == 404:
            raise KeyError(str(payload.get("error") or
                               f"{universe!r}/{month} not serveable"))
        if status == 504:
            # The member answered that the deadline expired: the
            # client's error, not retried and not fed to the breaker.
            raise DeadlineError(universe, int(month), 0.0)
        if status != 200:
            raise MemberCallError(
                self.name, f"HTTP {status}: {payload.get('error')}",
                status=status)
        return ScoreResponse(
            universe=payload["universe"], month=int(payload["month"]),
            generation=int(payload["generation"]),
            firm_idx=np.asarray(payload["firm_idx"], np.int32),
            scores=np.asarray(payload["scores"], np.float32),
            latency_ms=float(payload.get("latency_ms") or 0.0),
            request_id=str(payload.get("request_id") or ""),
            phases=payload.get("phases"))

    def health(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        status, payload = self._get_json("/healthz", timeout_s=timeout_s)
        if not isinstance(payload, dict):
            raise MemberCallError(self.name, "malformed /healthz body",
                                  status=status)
        return payload

    def snapshot(self) -> Dict[str, Any]:
        _, stats = self._get_json("/stats")
        return {"stats": stats, "health": self.health()}

    def metrics_text(self) -> str:
        status, body = self._get("/metrics")
        if status != 200:
            raise MemberCallError(self.name, f"/metrics HTTP {status}",
                                  status=status)
        return body.decode()

    def join_report(self) -> Dict[str, Any]:
        status, payload = self._get_json("/fleet")
        if status != 200 or not isinstance(payload, dict):
            raise MemberCallError(self.name, f"/fleet HTTP {status}",
                                  status=status)
        payload.setdefault("member", self.name)
        months = payload.get("months")
        if isinstance(months, dict):
            self._months = {u: [int(m) for m in ms]
                            for u, ms in months.items()}
        return payload

    def universes(self) -> Dict[str, int]:
        _, stats = self._get_json("/stats")
        return {u: int(g) for u, g in (stats.get("universes")
                                       or {}).items()}

    def serveable_months(self, universe: str) -> List[int]:
        if universe not in self._months:
            self.join_report()
        if universe not in self._months:
            raise KeyError(f"universe {universe!r} is not served by "
                           f"member {self.name!r}")
        return list(self._months[universe])

    def sync(self) -> List[Dict[str, Any]]:
        status, payload = self._get_json("/sync")
        if status != 200:
            raise MemberCallError(self.name, f"/sync HTTP {status}: "
                                             f"{payload.get('error')}",
                                  status=status)
        self._months = {}  # a newer generation may serve other months
        return payload.get("synced", [])

    def close(self) -> None:
        pass  # the spawner owns the process


# ---- the coordinator ------------------------------------------------------


class MemberJoinRefused(RuntimeError):
    """The join gate refused a member: its restore report is missing or
    unverified, it is behind the fence after a sync, or the store's probe
    scored through it is not bitwise equal. It is never routed to."""


class _MemberSlot:
    """One member's coordinator-side state: its registry entry and the
    router's health and breaker machine (guarded by the coordinator's
    lock)."""

    __slots__ = ("name", "member", "state", "fail_streak", "out_until",
                 "probing", "universes", "health_cache", "health_ts",
                 "health_inflight", "degraded", "served", "failures",
                 "last_error", "info")

    def __init__(self, name: str, member: Any):
        self.name = name
        self.member = member
        self.state = "in"          # in | out
        self.fail_streak = 0
        self.out_until = 0.0       # perf_counter seconds
        self.probing = False       # half-open: ONE probe in flight
        self.universes: Dict[str, int] = {}
        self.health_cache: Optional[Dict[str, Any]] = None
        self.health_ts = -1e18     # perf_counter of the last probe
        self.health_inflight = False
        self.degraded = False      # SLO burning: deprioritized
        self.served = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        self.info: Dict[str, Any] = {}


def _hrw(key: str, member: str) -> int:
    """Rendezvous (highest-random-weight) score: a function of the (key,
    member) pair alone, so every router ranks the members alike whatever
    their registration order."""
    return int.from_bytes(
        sha256(f"{key}|{member}".encode()).digest()[:8], "big")


class FleetCoordinator:
    """The fleet's shared state: the member registry, consistent routing
    with replication, the store's publish fence and the join gate.
    Thread-safe; routing is pure hashing over the registry."""

    def __init__(self, store: Any = None, replicas: Optional[int] = None):
        self.store = store
        self._default_replicas = (replicas_default() if replicas is None
                                  else max(1, int(replicas)))
        self._replica_overrides: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._slots: Dict[str, _MemberSlot] = {}
        # fence() memo keyed on the manifest file's stat.
        self._fence_cache: Optional[Tuple[Any, Dict[str, int]]] = None

    @classmethod
    def local(cls, service: Any, name: str = "m0",
              replicas: Optional[int] = None) -> "FleetCoordinator":
        """The one-member fleet: a service wrapped as a member, admitted
        unverified (it is the authority it would be verified against)."""
        coord = cls(store=getattr(service, "store", None),
                    replicas=replicas)
        coord.add_member(LocalMember(name, service), verify=False)
        return coord

    # ---- registry / join gate ---------------------------------------

    def add_member(self, member: Any, verify: bool = True
                   ) -> Dict[str, Any]:
        """Admit a member through the gate. With ``verify`` its join
        report must show every restored generation ``bit_equal``, every
        served generation at the store's fence (a member behind it gets
        ONE ``sync()``), and the store's probe month scored through it
        bitwise equal to the probe. A refusal raises
        :class:`MemberJoinRefused`. Returns the accepted report."""
        name = member.name
        try:
            rep = member.join_report()
        except Exception as e:  # noqa: BLE001 — refusal, not a crash
            self._refuse(name, f"join report unavailable "
                               f"({type(e).__name__}: {e})")
        unis = {u: int(g) for u, g in (rep.get("universes") or {}).items()}
        if verify:
            restore = rep.get("restore")
            if restore is not None:
                bad = [r for r in restore if r.get("probe") != "bit_equal"]
                if bad:
                    self._refuse(
                        name, "restore report carries unverified "
                        f"generations: {[r.get('universe') for r in bad]}"
                        " (probe != bit_equal)")
            fence = self.fence()
            behind = {u for u, g in fence.items() if unis.get(u, -1) < g}
            if behind:
                try:
                    member.sync()
                    unis = {u: int(g)
                            for u, g in member.universes().items()}
                except Exception as e:  # noqa: BLE001 — refusal below
                    self._refuse(name, f"behind fence {sorted(behind)} "
                                       f"and sync failed "
                                       f"({type(e).__name__}: {e})")
                behind = {u for u, g in fence.items()
                          if unis.get(u, -1) < g}
            if behind:
                self._refuse(
                    name, f"still behind the publish fence after sync: "
                          f"{sorted(behind)}")
            # The active probe: a self-reported verdict alone would admit
            # a member serving its own, different params.
            if self.store is not None:
                for u in sorted(set(fence) & set(unis)):
                    pr = self.store.probe_record(u)
                    if pr is None:
                        continue
                    try:
                        live = member.score(
                            u, pr["month"],
                            timeout_s=member_timeout_ms_default() / 1e3)
                    except Exception as e:  # noqa: BLE001 — refusal below
                        self._refuse(
                            name, f"parity probe for {u!r} could not "
                                  f"run ({type(e).__name__}: {e})")
                    if not (np.array_equal(live.firm_idx, pr["firm_idx"])
                            and np.array_equal(
                                live.scores.astype(np.float32),
                                pr["scores"])):
                        self._refuse(
                            name, f"parity probe mismatch for {u!r}: "
                                  f"month {pr['month']} scored through "
                                  "the member is not bit-equal to the "
                                  "store's publish-time probe")
        slot = _MemberSlot(name, member)
        slot.universes = unis
        build = rep.get("build") or {}
        slot.info = {
            "host": build.get("host"),
            "pid": build.get("pid") or getattr(member, "pid", None),
            "restore_compiles": rep.get("restore_compiles"),
        }
        with self._lock:
            self._slots[name] = slot
        telemetry.COUNTERS.bump("fleet_joins")
        telemetry.instant("fleet_member_joined", cat="fleet",
                          member=name, universes=sorted(unis),
                          restore_compiles=rep.get("restore_compiles"),
                          host=slot.info.get("host"),
                          pid=slot.info.get("pid"))
        return rep

    def _refuse(self, name: str, reason: str) -> None:
        telemetry.COUNTERS.bump("fleet_refusals")
        telemetry.instant("fleet_member_refused", cat="fleet",
                          member=name, reason=reason)
        raise MemberJoinRefused(
            f"member {name!r} refused at the join gate: {reason}")

    def remove_member(self, name: str) -> None:
        with self._lock:
            self._slots.pop(name, None)

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def member(self, name: str) -> Any:
        with self._lock:
            return self._slots[name].member

    def slot(self, name: str) -> _MemberSlot:
        with self._lock:
            return self._slots[name]

    # ---- replication / routing --------------------------------------

    def set_replicas(self, universe: str, n: int) -> None:
        """Widen (or narrow) one universe's replica set beyond
        ``LFM_FLEET_REPLICAS`` (capped at the member count at route
        time)."""
        with self._lock:
            self._replica_overrides[universe] = max(1, int(n))

    def replicas(self, universe: str) -> int:
        with self._lock:
            return self._replica_overrides.get(universe,
                                               self._default_replicas)

    def route(self, universe: str, month: Optional[int] = None
              ) -> List[str]:
        """Member names in attempt order: rendezvous hashing ranks the
        members that hold the universe, the top ``replicas(universe)``
        are its replica set (spread over it by month), the others trail
        as last resorts. A function of (universe, month, member names)
        alone."""
        with self._lock:
            holders = [n for n, s in self._slots.items()
                       if universe in s.universes]
        if not holders:
            raise KeyError(
                f"universe {universe!r} is not served by any fleet "
                f"member (members: {self.members()})")
        ranked = sorted(holders, key=lambda n: _hrw(universe, n),
                        reverse=True)
        r = max(1, min(self.replicas(universe), len(ranked)))
        replica_set, rest = ranked[:r], ranked[r:]
        if month is not None and len(replica_set) > 1:
            start = _hrw(universe, str(int(month))) % len(replica_set)
            replica_set = replica_set[start:] + replica_set[:start]
        return replica_set + rest

    # ---- the publish fence ------------------------------------------

    def fence(self) -> Dict[str, int]:
        """Universe → committed generation, from the store's manifest
        (the one commit point of every publish), cached on the manifest
        file's (mtime, size). Without a store: the highest generation
        any member serves."""
        if self.store is not None:
            try:
                st = os.stat(self.store.manifest_path)
                stamp: Any = (st.st_mtime_ns, st.st_size)
            except OSError:
                stamp = None
            with self._lock:
                if self._fence_cache is not None \
                        and self._fence_cache[0] == stamp:
                    return dict(self._fence_cache[1])
            manifest = self.store.load_manifest(quarantine=False) or {}
            out: Dict[str, int] = {}
            for u, rec in (manifest.get("universes") or {}).items():
                gens = [int(g["generation"])
                        for g in rec.get("generations", [])]
                if gens:
                    out[u] = max(gens)
            with self._lock:
                self._fence_cache = (stamp, dict(out))
            return out
        out = {}
        with self._lock:
            for s in self._slots.values():
                for u, g in s.universes.items():
                    out[u] = max(out.get(u, -1), int(g))
        return out

    def sync_members(self) -> Dict[str, Any]:
        """Propagate the fence: every member behind it pulls the newer
        generations from the store (``sync``, verified like a restore).
        A member whose sync fails goes OUT (it would serve a stale
        generation); a successful sync readmits an OUT member. Returns
        the per-member outcomes."""
        fence = self.fence()
        out: Dict[str, Any] = {"fence": fence, "members": {}}
        with self._lock:
            slots = list(self._slots.values())
        for slot in slots:
            behind = {u for u, g in fence.items()
                      if slot.universes.get(u, -1) < g}
            if not behind:
                out["members"][slot.name] = {"synced": 0,
                                             "up_to_date": True}
                continue
            try:
                synced = slot.member.sync()
                unis = {u: int(g)
                        for u, g in slot.member.universes().items()}
                with self._lock:
                    slot.universes = unis
                still = {u for u, g in fence.items()
                         if unis.get(u, -1) < g}
                if still:
                    raise MemberCallError(
                        slot.name, f"still behind the fence after sync: "
                                   f"{sorted(still)}")
                out["members"][slot.name] = {
                    "synced": len(synced), "up_to_date": True}
                with self._lock:
                    readmit = slot.state == "out"
                    if readmit:
                        slot.state = "in"
                        slot.probing = False
                        slot.fail_streak = 0
                if readmit:
                    telemetry.COUNTERS.bump("fleet_readmissions")
                    telemetry.instant("fleet_member_readmitted",
                                      cat="fleet", member=slot.name,
                                      via="sync")
                telemetry.instant("fleet_member_synced", cat="fleet",
                                  member=slot.name,
                                  generations=len(synced))
            except Exception as e:  # noqa: BLE001 — stale member goes out
                with self._lock:
                    slot.state = "out"
                    slot.out_until = time.perf_counter() + 86400.0
                    slot.last_error = f"{type(e).__name__}: {e}"
                telemetry.COUNTERS.bump("fleet_member_out")
                telemetry.instant("fleet_member_out", cat="fleet",
                                  member=slot.name, reason="sync_failed",
                                  error=type(e).__name__)
                out["members"][slot.name] = {
                    "synced": 0, "up_to_date": False,
                    "error": f"{type(e).__name__}: {e}"}
        return out

    # ---- views -------------------------------------------------------

    def universes(self) -> List[str]:
        out = set()
        with self._lock:
            for s in self._slots.values():
                out.update(s.universes)
        return sorted(out)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "members": {
                    n: {"state": s.state, "probing": s.probing,
                        "degraded": s.degraded,
                        "served": s.served, "failures": s.failures,
                        "fail_streak": s.fail_streak,
                        "universes": dict(s.universes),
                        "last_error": s.last_error,
                        **{k: v for k, v in s.info.items()
                           if v is not None}}
                    for n, s in self._slots.items()},
                "replicas_default": self._default_replicas,
                "replica_overrides": dict(self._replica_overrides),
            }

    def close(self) -> None:
        with self._lock:
            slots = list(self._slots.values())
            self._slots.clear()
        for s in slots:
            try:
                s.member.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass


# ---- the router -----------------------------------------------------------


class FleetRouter:
    """The fleet's front door: failover routing over a
    :class:`FleetCoordinator`, with the surface the HTTP front door and
    the load clients read from a ``ScoringService`` (``score`` /
    ``snapshot`` / ``stats`` / ``health`` / ``metrics_text`` /
    ``serveable_months``), so ``make_http_server(router, port)`` serves a
    fleet with the single process's error taxonomy; exhausting every
    candidate raises :class:`MemberUnavailableError` (503 +
    Retry-After)."""

    #: Health probe timeout (s): short, so a wedged member's /healthz
    #: never holds a request for the whole member-call budget.
    HEALTH_PROBE_TIMEOUT_S = 2.0

    def __init__(self, coordinator: FleetCoordinator,
                 retries: Optional[int] = None,
                 breaker: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 health_ttl_ms: Optional[float] = None,
                 member_timeout_ms: Optional[float] = None):
        self.coord = coordinator
        self.retries = retries_default() if retries is None \
            else max(0, int(retries))
        self.breaker = breaker_default() if breaker is None \
            else max(1, int(breaker))
        self.cooldown_s = (cooldown_ms_default() if cooldown_ms is None
                           else max(0.0, float(cooldown_ms))) / 1e3
        self.health_ttl_s = (health_ttl_ms_default()
                             if health_ttl_ms is None
                             else max(0.0, float(health_ttl_ms))) / 1e3
        self.member_timeout_s = (member_timeout_ms_default()
                                 if member_timeout_ms is None
                                 else float(member_timeout_ms)) / 1e3
        self._stats_lock = threading.Lock()
        self._lat_ms: List[float] = []
        self._requests = 0
        self._rerouted = 0
        self._failovers = 0
        self._unroutable = 0

    # ---- member state machine ---------------------------------------

    def _admit(self, slot: _MemberSlot, now: float) -> str:
        """May this request try the member? ``yes`` | ``probe`` (the
        half-open probe, one in flight) | ``no``. A stale health cache
        is refreshed from the member's /healthz (single-flight): an
        unready member goes OUT with its advertised retry-after as the
        cooldown, a burning SLO marks it degraded."""
        with self.coord._lock:
            if slot.state == "out":
                if now >= slot.out_until and not slot.probing:
                    slot.probing = True
                    probe = True
                else:
                    return "no"
            else:
                probe = False
            fresh = (now - slot.health_ts) <= self.health_ttl_s
            refresh = not probe and not fresh and not slot.health_inflight
            if refresh:
                slot.health_inflight = True
        if probe:
            telemetry.COUNTERS.bump("fleet_probes")
            telemetry.instant("fleet_member_probe", cat="fleet",
                              member=slot.name)
            return "probe"
        if not refresh:
            h = slot.health_cache
            return "yes" if (h is None or h.get("ok", True)) else "no"
        try:
            h = slot.member.health(
                timeout_s=min(self.HEALTH_PROBE_TIMEOUT_S,
                              self.member_timeout_s))
        except Exception as e:  # noqa: BLE001 — an unreachable member is out
            self._member_failed(slot, e, probing=False,
                                reason="health_unreachable")
            return "no"
        finally:
            with self.coord._lock:
                slot.health_inflight = False
        with self.coord._lock:
            slot.health_cache = h
            slot.health_ts = now
            slot.degraded = bool((h.get("slo") or {}).get("burning"))
        if not h.get("ok", True):
            self._mark_out(
                slot, reason=f"unready:{h.get('circuit', '?')}",
                cooldown_s=max(self.cooldown_s,
                               float(h.get("retry_after_s") or 0.0)))
            return "no"
        return "yes"

    def _mark_out(self, slot: _MemberSlot, reason: str,
                  cooldown_s: Optional[float] = None) -> None:
        with self.coord._lock:
            was_in = slot.state != "out"
            slot.state = "out"
            slot.probing = False
            slot.out_until = (time.perf_counter()
                              + (self.cooldown_s if cooldown_s is None
                                 else cooldown_s))
        if was_in:
            telemetry.COUNTERS.bump("fleet_member_out")
            telemetry.instant("fleet_member_out", cat="fleet",
                              member=slot.name, reason=reason)

    def _member_failed(self, slot: _MemberSlot, exc: BaseException,
                       probing: bool, reason: str = "call_failed") -> None:
        with self.coord._lock:
            slot.fail_streak += 1
            slot.failures += 1
            slot.last_error = f"{type(exc).__name__}: {exc}"
            streak = slot.fail_streak
        if probing:
            # The half-open probe failed: straight back out for a full
            # cooldown (counter and instant together, as an
            # out-transition).
            self._mark_out(slot, reason="probe_failed")
            telemetry.COUNTERS.bump("fleet_member_out")
            telemetry.instant("fleet_member_out", cat="fleet",
                              member=slot.name, reason="probe_failed",
                              error=type(exc).__name__)
        elif streak >= self.breaker:
            self._mark_out(slot, reason=reason)

    def _member_ok(self, slot: _MemberSlot, probing: bool) -> None:
        with self.coord._lock:
            slot.fail_streak = 0
            slot.served += 1
            readmitted = probing or slot.state == "out"
            slot.state = "in"
            slot.probing = False
            if readmitted:
                # The live probe proved the member healthy: drop a stale
                # ok=False health cache.
                slot.health_cache = None
                slot.health_ts = -1e18
        if readmitted:
            telemetry.COUNTERS.bump("fleet_readmissions")
            telemetry.instant("fleet_member_readmitted", cat="fleet",
                              member=slot.name)

    # ---- the request path -------------------------------------------

    def score(self, universe: str, month: int,
              timeout: Optional[float] = 60.0,
              request_id: Optional[str] = None) -> ScoreResponse:
        """Route one request: walk the candidate order (the replica set
        spread by month, then the last resorts), skip OUT members, admit
        at most one half-open probe, fail over on member-level errors
        with the batcher's backoff, at most ``retries`` further members.
        Client and data errors propagate unretried; exhaustion raises
        :class:`MemberUnavailableError`."""
        rid = clean_request_id(request_id) or new_request_id()
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        candidates = self.coord.route(universe, month)
        # Burning members drop behind healthy ones within their tier.
        r = max(1, min(self.coord.replicas(universe), len(candidates)))

        def _tier(names):
            out = []
            for name in names:
                try:
                    out.append(self.coord.slot(name))
                except KeyError:
                    continue  # removed concurrently
            return ([s for s in out if not s.degraded]
                    + [s for s in out if s.degraded])

        slots = _tier(candidates[:r]) + _tier(candidates[r:])
        primary = candidates[0]
        attempts_left = self.retries + 1
        tried = 0
        last_exc: Optional[BaseException] = None
        for slot in slots:
            if attempts_left <= 0:
                break
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                raise DeadlineError(universe, int(month), now - deadline)
            admit = self._admit(slot, now)
            if admit == "no":
                continue
            attempts_left -= 1
            tried += 1
            remaining = (None if deadline is None
                         else max(0.05, deadline - time.perf_counter()))
            per_call = (self.member_timeout_s if remaining is None
                        else min(self.member_timeout_s, remaining))
            try:
                resp = slot.member.score(universe, int(month),
                                         timeout_s=per_call,
                                         request_id=rid)
            except Exception as e:  # noqa: BLE001 — classified below
                if not member_retryable(e):
                    # A client/data error is an answer: the member is
                    # alive and not fed to the breaker.
                    self._member_ok(slot, probing=(admit == "probe"))
                    raise
                self._member_failed(slot, e, probing=(admit == "probe"))
                last_exc = e
                with self._stats_lock:
                    self._failovers += 1
                telemetry.COUNTERS.bump("fleet_failovers")
                telemetry.instant("fleet_failover", cat="fleet",
                                  member=slot.name, universe=universe,
                                  error=type(e).__name__)
                backoff_sleep(tried)
                continue
            self._member_ok(slot, probing=(admit == "probe"))
            with self.coord._lock:
                slot.universes[universe] = resp.generation
            telemetry.COUNTERS.bump("fleet_requests")
            rerouted = slot.name != primary
            if rerouted:
                telemetry.COUNTERS.bump("fleet_reroutes")
                telemetry.instant("fleet_reroute", cat="fleet",
                                  universe=universe, member=slot.name,
                                  primary=primary)
            with self._stats_lock:
                self._requests += 1
                self._rerouted += int(rerouted)
                self._lat_ms.append(
                    round((time.perf_counter() - t0) * 1e3, 3))
                if len(self._lat_ms) > 65536:
                    del self._lat_ms[:32768]
            return resp
        with self._stats_lock:
            self._unroutable += 1
        telemetry.COUNTERS.bump("fleet_unroutable")
        telemetry.instant("fleet_unroutable", cat="fleet",
                          universe=universe, tried=tried,
                          error=(type(last_exc).__name__
                                 if last_exc else None))
        raise MemberUnavailableError(
            universe, tried=tried, retry_after_s=max(0.1, self.cooldown_s))

    # ---- ScoringService-shaped surface ------------------------------

    def universes(self) -> List[str]:
        return self.coord.universes()

    def serveable_months(self, universe: str) -> List[int]:
        for name in self.coord.route(universe):
            try:
                return self.coord.member(name).serveable_months(universe)
            except Exception:  # noqa: BLE001 — next candidate
                continue
        raise KeyError(f"universe {universe!r}: no member answered a "
                       "serveable-months query")

    def health(self) -> Dict[str, Any]:
        return self.snapshot()["health"]

    def stats(self) -> Dict[str, Any]:
        return self.snapshot()["stats"]

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._lat_ms = []
            self._requests = self._rerouted = 0
            self._failovers = self._unroutable = 0

    def snapshot(self) -> Dict[str, Any]:
        """The fleet twin of ``ScoringService.snapshot()``: ``{ts, stats,
        health}`` over every member's registry state and the router's
        counters. Ready when every universe has an IN member holding it
        (one member down is a reroute, not an outage)."""
        from lfm_quant_tpu_torch.serve.stats import latency_summary

        ts = time.time()
        csnap = self.coord.snapshot()
        with self._stats_lock:
            lat = list(self._lat_ms)
            stats: Dict[str, Any] = {
                "completed": self._requests,
                "rerouted": self._rerouted,
                "failovers": self._failovers,
                "unroutable": self._unroutable,
            }
        stats.update(latency_summary(lat))
        stats["ts"] = ts
        stats["members"] = csnap["members"]
        fence = self.coord.fence()
        unis = self.coord.universes()
        stats["universes"] = {u: fence.get(u) for u in unis}
        uncovered = [u for u in unis if not any(
            rec["state"] == "in" and u in rec["universes"]
            for rec in csnap["members"].values())]
        health: Dict[str, Any] = {
            "ok": not uncovered and bool(csnap["members"]),
            "ts": ts,
            "members": {n: {"state": rec["state"],
                            "degraded": rec["degraded"],
                            "fail_streak": rec["fail_streak"]}
                        for n, rec in csnap["members"].items()},
            "members_in": sum(1 for rec in csnap["members"].values()
                              if rec["state"] == "in"),
            "members_total": len(csnap["members"]),
        }
        if uncovered:
            health["reason"] = (
                f"no routable member for universe(s) {uncovered} — "
                "every replica is out")
            health["retry_after_s"] = round(self.cooldown_s, 3)
        elif not csnap["members"]:
            health["reason"] = "fleet has no members"
        return {"ts": ts, "stats": stats, "health": health}

    def fleet_info(self) -> Dict[str, Any]:
        """The router's ``/fleet`` answer: topology, fence, replicas."""
        snap = self.coord.snapshot()
        return {"router": True, "members": snap["members"],
                "replicas_default": snap["replicas_default"],
                "replica_overrides": snap["replica_overrides"],
                "fence": self.coord.fence(),
                "universes": self.universes()}

    def metrics_text(self, ts: Optional[float] = None) -> str:
        """The fleet's ``/metrics``: the router process's registry and
        counters (the ``lfm_fleet_*`` series), then every REMOTE member's
        scrape with ``member="name"`` on each series (comment lines
        dropped: one document, no repeated TYPE lines). In-process
        members share this process's registry, already in the first
        block."""
        from lfm_quant_tpu_torch.utils import metrics

        parts = [metrics.render_prometheus(
            metrics.METRICS, counters=telemetry.COUNTERS.snapshot(), ts=ts)]
        for name in self.coord.members():
            slot = self.coord.slot(name)
            if not getattr(slot.member, "remote", False):
                continue
            try:
                text = slot.member.metrics_text()
            except Exception as e:  # noqa: BLE001 — dead: no scrape
                parts.append(f"# member {name} scrape unavailable: "
                             f"{type(e).__name__}\n")
                continue
            parts.append(relabel_scrape(text, name))
        return "".join(parts)

    def close(self) -> None:
        self.coord.close()


def relabel_scrape(text: str, member: str) -> str:
    """Inject ``member="name"`` into every series of a member's scrape
    (comment lines dropped, so concatenated blocks never repeat a
    ``# TYPE``); the result is what the ``parse_prometheus`` twins
    read."""
    out: List[str] = []
    tag = f'member="{member}"'
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            out.append(f"{line[:brace + 1]}{tag},{line[brace + 1:]}"
                       if line[brace + 1] != "}" else
                       f"{line[:brace + 1]}{tag}{line[brace + 1:]}")
        elif space != -1:
            out.append(f"{line[:space]}{{{tag}}}{line[space:]}")
        else:
            out.append(line)
    return "\n".join(out) + ("\n" if out else "")


# ---- subprocess member entry / spawner -----------------------------------


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, default=str)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def member_main(argv: Optional[List[str]] = None) -> int:
    """A member (``python -m lfm_quant_tpu_torch.serve.fleet``): stand a
    ScoringService up from the store ALONE (read-only attach, restore,
    the verification ladder, the warm ladder), write the join report
    (port, pid, restore verdicts, nvcc builds and panel uploads of the
    restore) to the ready file, and serve the HTTP front door until
    killed. Runs on the card unless ``--device cpu``. A member that
    restores nothing exits 2: it has nothing to be admitted for."""
    import argparse
    import socket

    ap = argparse.ArgumentParser(description=member_main.__doc__)
    ap.add_argument("--store", required=True,
                    help="durable zoo store directory (the deploy "
                         "artifact this member bootstraps from)")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral; the ready file "
                         "carries the bound port)")
    ap.add_argument("--ready-file", default=None,
                    help="write the join report JSON here once serving")
    ap.add_argument("--max-rows", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lfm_quant_tpu_torch.serve.http import make_http_server
    from lfm_quant_tpu_torch.serve.service import ScoringService

    # The published serving geometry: the probe was scored at
    # bucket_rows(1, max_rows), so a member adopts the publisher's cap.
    max_rows = args.max_rows
    if max_rows is None:
        max_rows = store_max_rows(args.store)
    svc = ScoringService(device=args.device, persist_dir=args.store,
                         persist_readonly=True, max_rows=max_rows,
                         max_wait_ms=args.max_wait_ms)
    restored = svc.restore()
    if not restored:
        print("[fleet-member] restored NOTHING from the store — "
              "refusing to serve (nothing verified)", flush=True)
        svc.close()
        return 2
    httpd = make_http_server(svc, args.port)
    port = httpd.server_address[1]
    report = join_report(svc, member=f"{socket.gethostname()}:{port}",
                         port=port, pid=os.getpid())
    report.pop("months")
    if args.ready_file:
        _atomic_write_json(args.ready_file, report)
    print(f"[fleet-member] ready on 127.0.0.1:{port} "
          f"({len(restored)} universe(s), "
          f"{report['restore_compiles']} kernel builds, "
          f"{report['restore_panel_h2d']} panel uploads)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        svc.close()
    return 0


def store_max_rows(store_dir: str) -> Optional[int]:
    """The serving row cap the store's committed generations were
    published under (None without a committed manifest)."""
    from lfm_quant_tpu_torch.serve.persist import ZooStore

    manifest = ZooStore(store_dir, readonly=True).load_manifest(
        quarantine=False) or {}
    vals = [int(g.get("max_rows", 0))
            for u in (manifest.get("universes") or {}).values()
            for g in u.get("generations", [])]
    vals = [v for v in vals if v > 0]
    return max(vals) if vals else None


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def spawn_member(store_dir: str, *, ready_file: str, port: int = 0,
                 env: Optional[Dict[str, str]] = None,
                 max_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 device: Optional[str] = None):
    """Start one member subprocess bootstrapping from ``store_dir`` and
    return its ``Popen`` at once; pair with :func:`wait_member_ready`
    (start several, then wait, so their start-ups overlap). Its stdout
    and stderr go to ``<ready_file>.log``, a file, never an undrained
    pipe."""
    import subprocess
    import sys

    root = repo_root()
    # The member runs from the repo root: relative paths would move.
    store_dir = os.path.abspath(store_dir)
    ready_file = os.path.abspath(ready_file)
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    child_env["PYTHONPATH"] = (
        root + os.pathsep + child_env["PYTHONPATH"]
        if child_env.get("PYTHONPATH") else root)
    cmd = [sys.executable, "-m", "lfm_quant_tpu_torch.serve.fleet",
           "--store", store_dir, "--port", str(port),
           "--ready-file", ready_file]
    if max_rows is not None:
        cmd += ["--max-rows", str(max_rows)]
    if max_wait_ms is not None:
        cmd += ["--max-wait-ms", str(max_wait_ms)]
    if device is not None:
        cmd += ["--device", str(device)]
    log_path = ready_file + ".log"
    log_fh = open(log_path, "ab", buffering=0)
    try:
        proc = subprocess.Popen(cmd, cwd=root, env=child_env,
                                stdout=log_fh, stderr=log_fh)
    finally:
        log_fh.close()  # the child holds its own descriptor
    proc.lfm_log_path = log_path
    return proc


def _log_tail(proc, ready_file: str, n: int = 800) -> str:
    path = getattr(proc, "lfm_log_path", ready_file + ".log")
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - 4096))
            return fh.read().decode(errors="replace")[-n:]
    except OSError:
        return "(no member log)"


def wait_member_ready(proc, ready_file: str, timeout_s: float = 240.0
                      ) -> Dict[str, Any]:
    """Block until the member's ready file appears (its join report) or
    the process dies or the timeout expires (RuntimeError with the tail
    of the member's log; a timed-out member is killed)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if os.path.exists(ready_file):
            try:
                with open(ready_file) as fh:
                    return json.load(fh)
            except (OSError, json.JSONDecodeError):
                pass  # mid-rename; retry
        if proc.poll() is not None:
            raise RuntimeError(
                f"fleet member died during bootstrap (rc="
                f"{proc.returncode}): {_log_tail(proc, ready_file)}")
        time.sleep(0.05)
    proc.kill()
    raise RuntimeError(
        f"fleet member not ready within {timeout_s:.0f}s "
        f"(ready file {ready_file} never appeared): "
        f"{_log_tail(proc, ready_file)}")


if __name__ == "__main__":
    import sys

    sys.exit(member_main())
