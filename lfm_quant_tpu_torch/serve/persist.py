"""Durable serving state: journaled zoo snapshots, crash-consistent
publish, verified restore.

Port of ``lfm_quant_tpu/serve/persist.py``. Everything the serving
process holds (zoo generations, drift reference sketches) is process
memory; :class:`ZooStore` writes every published generation to a
directory so that a crashed or restarted process stands back up from it
instead of retraining:

* **Snapshots**: the params as host float32 tensors (``torch.save``,
  read back with ``torch.load(weights_only=True)``) with their sha256
  (:func:`params_checksum`, the JAX package's digest for the same
  params), the universe's panel as a content-addressed ``.npz`` (the
  JAX package's bytes for the same panel), the run config and split
  boundaries, the publish-time drift reference sketch, and a parity
  probe: one serveable month scored at the warmed geometry
  (:func:`score_single_month`), float32 bit for bit.
* **Write-ahead journal and one commit point**: a publish appends a
  ``begin`` intent to ``journal.jsonl`` (fsync'd), stages every
  artifact, then commits by atomically replacing ``manifest.json``
  (temp file, fsync, rename, directory fsync) and appends ``commit``.
  A crash at any instant, which the ``zoo_persist`` and
  ``manifest_write`` fault sites reproduce (``kind=sigkill`` for a real
  SIGKILL), leaves the old manifest or the new one, never a torn one.
  :meth:`ZooStore.sweep` reclaims a crashed publish's debris at the
  next start.
* **Restore** (:meth:`ZooStore.restore_into`): every universe of the
  manifest, newest committed generation first, verified before it may
  serve: the panel's hash, the params' checksum, then the probe month
  scored through the restored generation must be BITWISE equal to the
  publish-time probe. A corrupt or mismatched snapshot is quarantined
  (renamed ``*.quarantined.*``, loudly) and the restore falls back to
  the next-older committed generation, or to nothing. A failure of the
  environment (a device fault, out of memory) fails the attempt and
  never quarantines. Drift references are re-stamped from the
  serialized sketches.
* **Retention**: ``LFM_ZOO_KEEP_GENERATIONS`` (default 2) newest
  generations per universe stay in the manifest; superseded ones leave
  the manifest first and their directories are deleted after the
  commit.

What has no twin here: the JAX package exports each warmed bucket's
lowered executable (``_export_execs``) and keys it by a program
fingerprint. PyTorch runs eagerly and the kernels live in one library
built per source digest, so a generation's ``execs`` stay empty and its
``program_fingerprint`` records the torch and CUDA versions, the card
and the kernel library's digest (:func:`program_fingerprint`). A
restore's compile cost is the ``nvcc`` builds it caused
(``kernel_builds``: none when ``build/lfm_quant_tpu_torch/`` already
holds the library of this digest).

Single-writer contract: one serving process owns a store directory at a
time; fleet members attach read-only. ``LFM_ZOO_PERSIST`` unset or
``0`` is an exact no-op: the service holds no store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import tempfile
import threading
import time
import warnings
import weakref
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from lfm_quant_tpu_torch.serve.buckets import (
    bucket_rows,
    bucket_width,
    rows_ladder,
)
from lfm_quant_tpu_torch.serve.errors import SnapshotIntegrityError
from lfm_quant_tpu_torch.utils import faults, telemetry

#: Manifest schema version. A manifest of another schema is rejected
#: loudly at restore (quarantine, fresh start), never half-parsed.
SCHEMA_VERSION = 1


def persist_dir_default() -> Optional[str]:
    """``LFM_ZOO_PERSIST``: the durable store directory. Unset, empty or
    ``"0"`` disables persistence (the exact-no-op contract)."""
    v = os.environ.get("LFM_ZOO_PERSIST", "")
    return None if v in ("", "0") else v


def persist_enabled() -> bool:
    """Whether durable zoo persistence is configured."""
    return persist_dir_default() is not None


def keep_generations_default() -> int:
    """``LFM_ZOO_KEEP_GENERATIONS``: committed generations kept per
    universe (default 2: the serving one plus one rollback)."""
    return max(1, int(os.environ.get("LFM_ZOO_KEEP_GENERATIONS", "2")))


# ---- pure helpers --------------------------------------------------------


def _path_key(path: str) -> Tuple[str, ...]:
    return tuple(path.split("/"))


def host_params(model: Any) -> Dict[str, np.ndarray]:
    """A model's params by Flax path as host float32 arrays: the bytes
    the checksum and the snapshot cover."""
    from lfm_quant_tpu_torch.weights import flax_param_map

    return {k: p.detach().float().cpu().numpy()
            for k, p in flax_param_map(model).items()}


def params_checksum(params: Mapping[str, Any]) -> str:
    """sha256 over the params' leaves (shape, dtype and raw bytes) in
    the order ``jax.tree.leaves`` takes a nested dict: sorted keys at
    every level. ``params`` is nested or flat with ``/``-joined Flax
    paths (``weights.flatten_params``); the digest of params carried
    across from the JAX package equals its ``params_checksum``."""
    from lfm_quant_tpu_torch.weights import flatten_params

    flat = flatten_params(params)
    h = hashlib.sha256()
    for key in sorted(flat, key=_path_key):
        a = np.asarray(flat[key])
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def program_fingerprint() -> Dict[str, Any]:
    """What a served number depends on besides the snapshot: the torch
    and CUDA versions, the card, and the digest of the kernel library's
    sources and flags (``ops/_build.py _digest``). Recorded with every
    generation; a restore under another fingerprint still verifies
    bitwise through the probe, which is the gate."""
    import torch

    from lfm_quant_tpu_torch.ops import _build

    cuda = torch.cuda.is_available()
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "kernels": _build._digest()}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def score_single_month(entry: Any, month: int, max_rows: int) -> np.ndarray:
    """Score ONE month at the warmed geometry ``bucket_rows(1,
    max_rows)`` x ``bucket_width(pool.size)`` through
    ``ZooEntry.score_device``. The publish-time probe and the restore's
    check both run through here, at the same geometry: another row
    count may pick another product algorithm and round differently."""
    t = entry.month_col(int(month))
    pool = entry.pool(t)
    if pool.size == 0:
        raise ValueError(f"probe month {month} has an empty pool")
    width = bucket_width(pool.size)
    rows = bucket_rows(1, max_rows)
    fi = np.zeros((rows, width), np.int32)
    ti = np.full((rows,), t, np.int32)
    w = np.zeros((rows, width), np.float32)
    fi[0, :pool.size] = pool
    fi[0, pool.size:] = pool[-1]
    w[0, :pool.size] = 1.0
    for i in range(1, rows):
        fi[i], ti[i] = fi[0], ti[0]
    out = entry.score_device(fi, ti, w).cpu().numpy()
    return out[0, :pool.size].copy()


def _panel_npz_bytes(panel: Any) -> bytes:
    """A Panel as deterministic ``.npz`` bytes (same arrays, same bytes,
    same content address; byte-equal to the JAX package's)."""
    buf = io.BytesIO()
    arrays = {
        "features": panel.features, "targets": panel.targets,
        "target_valid": panel.target_valid, "valid": panel.valid,
        "returns": panel.returns, "dates": panel.dates,
        "firm_ids": panel.firm_ids,
        "feature_names": np.asarray(list(panel.feature_names), dtype=str),
        "horizon": np.asarray(panel.horizon, np.int64),
    }
    if panel.ret_valid is not None:
        arrays["ret_valid"] = panel.ret_valid
    np.savez(buf, **arrays)
    return buf.getvalue()


def _panel_from_npz(path: str) -> Any:
    from lfm_quant_tpu_torch.data.panel import Panel

    with np.load(path, allow_pickle=False) as z:
        return Panel(
            features=z["features"], targets=z["targets"],
            target_valid=z["target_valid"], valid=z["valid"],
            returns=z["returns"], dates=z["dates"],
            firm_ids=z["firm_ids"],
            feature_names=[str(s) for s in z["feature_names"]],
            horizon=int(z["horizon"]),
            ret_valid=z["ret_valid"] if "ret_valid" in z.files else None,
        )


#: Kinds a snapshot may record: the object the entry scored through
#: (``register`` serves a ``Predictor``, ``refresh`` the ``Trainer``
#: that fitted it). The JAX package also records ``EnsembleTrainer``;
#: the port's zoo serves no ensemble (it has no ``score_device``), so a
#: snapshot naming one is refused loudly, as any unknown kind is.
_TRAINER_KINDS = ("Predictor", "Trainer")


def _build_trainer(kind: str, cfg: Any, splits: Any,
                   params: Mapping[str, Any], device: Any) -> Any:
    """The scoring object of a snapshot, on ``device``, with its
    params."""
    if kind == "Predictor":
        from lfm_quant_tpu_torch.train.loop import Predictor

        return Predictor(cfg, splits.panel, params, device=device)
    if kind == "Trainer":
        from lfm_quant_tpu_torch.train.loop import Trainer

        trainer = Trainer(cfg, splits, run_dir=None, device=device)
        trainer.state = trainer.init_state(params)
        trainer.model.eval()
        return trainer
    raise ValueError(
        f"snapshot records unsupported trainer kind {kind!r} "
        f"(supported: {', '.join(_TRAINER_KINDS)})")


def _splits_record(predictor: Any) -> Dict[str, int]:
    """The split boundaries of an entry: its trainer's, else the
    config's default dates over its panel (a ``Predictor`` has none)."""
    splits = getattr(predictor, "splits", None)
    if splits is not None:
        return {"train_end_idx": int(splits.train_end_idx),
                "val_end_idx": int(splits.val_end_idx),
                "train_start_idx": int(splits.train_start_idx)}
    from lfm_quant_tpu_torch.train.loop import default_split_dates

    panel, d = predictor.panel, predictor.cfg.data
    train_end, val_end = default_split_dates(panel, d)
    start = (int(np.searchsorted(panel.dates, d.train_start))
             if d.train_start else 0)
    return {"train_end_idx": int(np.searchsorted(panel.dates, train_end)),
            "val_end_idx": int(np.searchsorted(panel.dates, val_end)),
            "train_start_idx": start}


class ZooStore:
    """One durable store directory for one serving process.

    Layout::

        <root>/manifest.json            # THE commit point
        <root>/journal.jsonl            # write-ahead intents (begin/commit)
        <root>/tmp/                     # atomic-write staging (swept)
        <root>/universes/<u>/panel_<hash12>.npz
        <root>/universes/<u>/gen_<g>/params.pt
        <root>/universes/<u>/gen_<g>/probe.npz

    ``readonly``: the store as a deploy artifact many fleet members
    attach at once. A read-only attach sweeps nothing, writes no journal
    or tmp file, renames nothing on a quarantine verdict, and refuses to
    publish.
    """

    def __init__(self, root: str, keep: Optional[int] = None,
                 readonly: bool = False):
        self.root = os.path.abspath(root)
        # Clamped like the env default: keep=0 would make the prune
        # slice `gens[:-0]` empty, retention off forever.
        self.keep = (max(1, int(keep)) if keep is not None
                     else keep_generations_default())
        self.readonly = bool(readonly)
        self.tmp_dir = os.path.join(self.root, "tmp")
        self.journal_path = os.path.join(self.root, "journal.jsonl")
        self.manifest_path = os.path.join(self.root, "manifest.json")
        if not self.readonly:
            os.makedirs(self.tmp_dir, exist_ok=True)
            os.makedirs(os.path.join(self.root, "universes"),
                        exist_ok=True)
        # register() and refresh() may publish from different threads of
        # one service: one manifest read-modify-write at a time, or a
        # racing pair could commit a manifest missing the other's record
        # (whose snapshot the next sweep would reclaim).
        self._commit_lock = threading.Lock()
        #: The owning service's IncidentManager (a quarantine triggers an
        #: evidence bundle); None when the store is used standalone.
        self.incidents: Optional[Any] = None
        # Same-panel publishes (a refresh over unchanged data) skip the
        # re-serialize and re-hash: id-keyed, weakref-validated.
        self._panel_memo: Dict[int, Tuple[Any, str]] = {}
        # Attaching the store is the process start: sweep the debris of
        # crashed publishes. quarantine=False: an attach never renames a
        # corrupt manifest aside (that is restore's loud decision).
        if not self.readonly:
            self.sweep(quarantine=False)

    # ---- low-level durability primitives -----------------------------

    def _atomic_write(self, path: str, data: bytes) -> None:
        """Temp file (in ``<root>/tmp``, the same filesystem), fsync,
        atomic rename, directory fsync: ``path`` holds its old content
        or ``data``, never a torn file."""
        fd, tmp = tempfile.mkstemp(dir=self.tmp_dir,
                                   prefix=os.path.basename(path) + ".")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _fsync_dir(os.path.dirname(path))

    def _journal(self, rec: Dict[str, Any]) -> None:
        """Append one fsync'd intent line: ``begin`` before any artifact
        is staged, ``commit`` after the manifest rename. A ``begin``
        without its ``commit`` marks a crashed publish."""
        with open(self.journal_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a failed artifact aside (never delete: it is the
        operator's evidence), loudly. A read-only attach reports the
        verdict with the same counter, instant and warning and renames
        nothing."""
        if self.readonly:
            telemetry.COUNTERS.bump("persist_quarantines")
            telemetry.instant("restore_quarantine", cat="serve",
                              path=os.path.relpath(path, self.root),
                              reason=reason[:200], readonly=True)
            if self.incidents is not None:
                self.incidents.trigger("quarantine",
                                       path=os.path.relpath(path, self.root),
                                       reason=reason[:200])
            warnings.warn(
                f"durable zoo: QUARANTINE verdict (read-only attach, "
                f"not renamed) {os.path.relpath(path, self.root)}: "
                f"{reason}", RuntimeWarning, stacklevel=3)
            return
        dst = f"{path}.quarantined.{int(time.time() * 1e3)}"
        try:
            os.replace(path, dst)
        except OSError as e:
            warnings.warn(
                f"durable zoo: could not quarantine {path} ({e}) — "
                f"original verification failure: {reason}",
                RuntimeWarning, stacklevel=3)
            return
        telemetry.COUNTERS.bump("persist_quarantines")
        telemetry.instant("restore_quarantine", cat="serve",
                          path=os.path.relpath(dst, self.root),
                          reason=reason[:200])
        if self.incidents is not None:
            self.incidents.trigger("quarantine",
                                   path=os.path.relpath(dst, self.root),
                                   reason=reason[:200])
        warnings.warn(
            f"durable zoo: QUARANTINED {os.path.relpath(path, self.root)} "
            f"→ {os.path.basename(dst)}: {reason}",
            RuntimeWarning, stacklevel=3)

    # ---- manifest ----------------------------------------------------

    def load_manifest(self, quarantine: bool = True
                      ) -> Optional[Dict[str, Any]]:
        """The committed manifest, or None when absent, corrupt or of
        another schema (then quarantined with a loud warning, unless
        ``quarantine=False``: the attach-time sweep's read-only mode)."""
        if not os.path.exists(self.manifest_path):
            return None
        try:
            with open(self.manifest_path) as fh:
                m = json.load(fh)
            if not isinstance(m, dict):
                raise ValueError(f"manifest root is {type(m).__name__}, "
                                 "not an object")
            schema = int(m.get("schema_version", -1))
        except (OSError, ValueError, TypeError) as e:
            if quarantine:
                self._quarantine(
                    self.manifest_path,
                    f"corrupt manifest: {type(e).__name__}: {e}")
            return None
        if schema != SCHEMA_VERSION:
            if quarantine:
                self._quarantine(
                    self.manifest_path,
                    f"manifest schema_version {schema} != supported "
                    f"{SCHEMA_VERSION} (a newer writer owns this store; "
                    "refusing to half-parse it)")
            return None
        return m

    def _commit_manifest(self, manifest: Dict[str, Any]) -> None:
        """The commit point: ``manifest_write`` checks bracket the atomic
        rename (even call index before, odd after), so a scheduled crash
        (``kind=sigkill`` too) lands on either side of it."""
        data = json.dumps(manifest, indent=1, sort_keys=True).encode()
        faults.check("manifest_write", phase="pre_rename")
        self._atomic_write(self.manifest_path, data)
        faults.check("manifest_write", phase="post_rename")

    # ---- publish -----------------------------------------------------

    def record_publish(self, entry: Any, max_rows: int,
                       probe_month: Optional[int] = None) -> Dict[str, Any]:
        """Durably record ``entry`` (a warmed, about-to-publish
        ZooEntry) as its universe's newest committed generation. The
        service calls this BEFORE the in-memory ``zoo.publish``: a crash
        after the commit restores the new generation, a crash before it
        the old one. Returns the generation record written."""
        if self.readonly:
            raise RuntimeError(
                "durable zoo: this store is attached READ-ONLY (a fleet "
                "member bootstrapping from the deploy artifact) — "
                "publishes belong to the store's single writer")
        with self._commit_lock:
            return self._record_publish_locked(
                entry, entry.universe, entry.generation, max_rows,
                probe_month)

    def _record_publish_locked(self, entry: Any, universe: str, gen: int,
                               max_rows: int,
                               probe_month: Optional[int]
                               ) -> Dict[str, Any]:
        import torch

        # Fail fast on an unreadable committed manifest, before staging
        # and WITHOUT quarantining it: a fresh manifest committed over it
        # would disown every other universe's snapshots, which the next
        # sweep would then reclaim.
        had_manifest = os.path.exists(self.manifest_path)
        manifest = self.load_manifest(quarantine=False)
        if manifest is None and had_manifest:
            raise RuntimeError(
                "durable zoo: refusing to publish over an unreadable "
                f"manifest ({self.manifest_path} is corrupt or from a "
                "newer schema) — committing a fresh manifest would "
                "disown other universes' committed snapshots; resolve "
                "(restore quarantines it loudly, or remove it by hand) "
                "first")
        manifest = manifest or {"schema_version": SCHEMA_VERSION,
                                "universes": {}}
        udir = os.path.join(self.root, "universes", universe)
        gdir_rel = os.path.join("universes", universe, f"gen_{gen:05d}")
        gdir = os.path.join(self.root, gdir_rel)
        replaced_rel: Optional[str] = None
        if os.path.exists(gdir):
            # The canonical name is taken: a crashed earlier attempt, or
            # a COMMITTED snapshot of the same generation being
            # re-published. Never touch it before the commit point;
            # stage under a unique name, reclaim the old one after.
            replaced_rel = gdir_rel
            gdir_rel = f"{gdir_rel}.r{int(time.time() * 1e3)}"
            gdir = os.path.join(self.root, gdir_rel)
        with telemetry.span("zoo_persist_commit", cat="serve",
                            universe=universe, generation=gen) as sp:
            self._journal({"op": "publish", "universe": universe,
                           "generation": gen, "dir": gdir_rel,
                           "state": "begin", "ts": time.time()})
            # A crash anywhere in the staging below leaves a dangling
            # `begin` and partial artifacts that sweep() reclaims.
            faults.check("zoo_persist", universe=universe, generation=gen)
            os.makedirs(udir, exist_ok=True)
            os.makedirs(gdir)

            # Panel: content-addressed per universe.
            memo = self._panel_memo.get(id(entry.panel))
            psha = (memo[1] if memo is not None
                    and memo[0]() is entry.panel else None)
            panel_rel = (os.path.join("universes", universe,
                                      f"panel_{psha[:12]}.npz")
                         if psha else None)
            if psha is None or not os.path.exists(
                    os.path.join(self.root, panel_rel)):
                pbytes = _panel_npz_bytes(entry.panel)
                psha = hashlib.sha256(pbytes).hexdigest()
                self._panel_memo = {k: v for k, v in
                                    self._panel_memo.items()
                                    if v[0]() is not None}
                self._panel_memo[id(entry.panel)] = (
                    weakref.ref(entry.panel), psha)
                panel_rel = os.path.join("universes", universe,
                                         f"panel_{psha[:12]}.npz")
                panel_path = os.path.join(self.root, panel_rel)
                if not os.path.exists(panel_path):
                    self._atomic_write(panel_path, pbytes)

            # Params: one host copy; the checksum and the file cover the
            # same bytes.
            predictor = entry.predictor
            params = host_params(predictor.model)
            pbuf = io.BytesIO()
            torch.save({k: torch.from_numpy(v) for k, v in params.items()},
                       pbuf)
            self._atomic_write(os.path.join(gdir, "params.pt"),
                               pbuf.getvalue())

            # Parity probe: one serveable month, float32 bit for bit.
            months = entry.serveable_months()
            month = int(probe_month if probe_month is not None
                        else months[len(months) // 2])
            probe_scores = score_single_month(entry, month, max_rows)
            pbuf = io.BytesIO()
            np.savez(pbuf, month=np.asarray(month, np.int64),
                     firm_idx=entry.pool(entry.month_col(month)),
                     scores=probe_scores.astype(np.float32))
            self._atomic_write(os.path.join(gdir, "probe.npz"),
                               pbuf.getvalue())

            fp = program_fingerprint()
            rec: Dict[str, Any] = {
                "generation": int(gen),
                "dir": gdir_rel,
                "trainer": type(predictor).__name__,
                "cfg": dataclasses.asdict(entry.cfg),
                "splits": _splits_record(predictor),
                "panel_file": panel_rel,
                "panel_sha256": psha,
                "params_sha256": params_checksum(params),
                "probe": {"month": month, "file":
                          os.path.join(gdir_rel, "probe.npz")},
                "ref_sketch": (entry.ref_sketch.to_state()
                               if entry.ref_sketch is not None else None),
                "buckets": [[int(r), int(w)] for r in rows_ladder(max_rows)
                            for w in entry.widths()],
                "max_rows": int(max_rows),
                "program_fingerprint": fp,
                "execs": {},
                "saved_at": time.time(),
            }
            manifest["schema_version"] = SCHEMA_VERSION
            manifest["saved_at"] = time.time()
            manifest["torch"] = {"version": fp["torch"], "cuda": fp["cuda"],
                                 "backend": str(predictor.device.type),
                                 "device": fp["device"],
                                 "kernels": fp["kernels"]}
            uni = manifest["universes"].setdefault(universe, {})
            # Records this commit supersedes: an earlier snapshot of the
            # same generation number.
            superseded = [g for g in uni.get("generations", [])
                          if g.get("generation") == int(gen)]
            gens: List[Dict[str, Any]] = [
                g for g in uni.get("generations", [])
                if g.get("generation") != int(gen)]
            gens.append(rec)
            gens.sort(key=lambda g: g["generation"])
            pruned = gens[:-self.keep] if len(gens) > self.keep else []
            uni["generations"] = gens[len(pruned):]

            # COMMIT. Before this line nothing is visible to a restore;
            # after it, cleanup of state the manifest no longer names.
            self._commit_manifest(manifest)
            self._journal({"op": "publish", "universe": universe,
                           "generation": gen, "state": "commit",
                           "ts": time.time()})
            self._gc(universe, manifest, pruned)
            kept_dirs = {g["dir"] for g in
                         manifest["universes"][universe]["generations"]}
            stale = {g["dir"] for g in superseded} | (
                {replaced_rel} if replaced_rel is not None else set())
            for rel in stale - kept_dirs:
                shutil.rmtree(os.path.join(self.root, rel),
                              ignore_errors=True)
            telemetry.COUNTERS.bump("persist_commits")
            sp.set(pruned=len(pruned))
        return rec

    # ---- retention / GC / sweep --------------------------------------

    def _gc(self, universe: str, manifest: Dict[str, Any],
            pruned: List[Dict[str, Any]]) -> None:
        """Delete the just-pruned generations' artifacts and any panel
        the kept generations no longer name. Failures warn: the next
        sweep reclaims the debt."""
        kept = manifest["universes"].get(universe, {}).get("generations", [])
        kept_panels = {g["panel_file"] for g in kept}
        for g in pruned:
            d = os.path.join(self.root, g["dir"])
            try:
                if os.path.isdir(d):
                    shutil.rmtree(d)
                telemetry.COUNTERS.bump("persist_gc_pruned")
            except OSError as e:
                warnings.warn(f"durable zoo GC: could not prune {d}: {e}",
                              RuntimeWarning, stacklevel=2)
            pf = g.get("panel_file")
            if pf and pf not in kept_panels:
                try:
                    os.unlink(os.path.join(self.root, pf))
                except OSError:
                    pass

    def sweep(self, quarantine: bool = True) -> Dict[str, int]:
        """Start-up recovery: replay the journal (a ``begin`` without its
        ``commit`` is a crashed publish whose staged artifacts go), empty
        ``tmp/``, and remove every artifact the committed manifest does
        not name. Idempotent; single-writer."""
        return self._sweep_impl(quarantine)[0]

    def _clear_tmp(self) -> int:
        n = 0
        for item in os.listdir(self.tmp_dir):
            try:
                p = os.path.join(self.tmp_dir, item)
                os.unlink(p) if os.path.isfile(p) else shutil.rmtree(p)
                n += 1
            except OSError:
                pass
        return n

    def _sweep_impl(self, quarantine: bool
                    ) -> Tuple[Dict[str, int], Optional[Dict[str, Any]]]:
        """Sweep and the manifest it loaded (one parse serves the sweep
        and the restore that follows it)."""
        if self.readonly:
            return ({"journal_replays": 0, "orphans": 0},
                    self.load_manifest(quarantine=False))
        replays = 0
        begun: Dict[Tuple[str, int], str] = {}
        for line in self._read_journal():
            if line.get("op") != "publish":
                continue
            key = (line.get("universe"), line.get("generation"))
            if line.get("state") == "begin":
                begun[key] = line.get("dir", "")
            elif line.get("state") == "commit":
                begun.pop(key, None)
        manifest = self.load_manifest(quarantine=quarantine)
        if manifest is None:
            # No readable committed reference set: the snapshots on disk
            # cannot be told apart from committed state, and deleting the
            # operator's evidence on the strength of a manifest we could
            # not read would turn an incident into data loss. Clean only
            # tmp/; keep the journal as evidence too.
            return ({"journal_replays": 0, "orphans": self._clear_tmp()},
                    None)
        referenced: set = set()
        for uni in manifest.get("universes", {}).values():
            for g in uni.get("generations", []):
                referenced.add(g["dir"])
                referenced.add(g["panel_file"])
        orphans = 0
        for rel in begun.values():
            # The crashed publish's dir goes unless the manifest names it
            # (the crash may have landed after the commit point but
            # before the journal's commit line).
            replays += 1
            if rel and rel not in referenced:
                d = os.path.join(self.root, rel)
                if os.path.isdir(d):
                    shutil.rmtree(d, ignore_errors=True)
                    orphans += 1
        # Unreferenced artifacts (GC failures, pre-journal debris);
        # quarantined ones are evidence and stay.
        ubase = os.path.join(self.root, "universes")
        for uname in sorted(os.listdir(ubase)) if os.path.isdir(ubase) \
                else []:
            udir = os.path.join(ubase, uname)
            if not os.path.isdir(udir):
                continue
            for item in sorted(os.listdir(udir)):
                rel = os.path.join("universes", uname, item)
                if ".quarantined." in item or rel in referenced:
                    continue
                path = os.path.join(udir, item)
                if item.startswith("gen_") and os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                    orphans += 1
                elif item.startswith("panel_") and item.endswith(".npz"):
                    try:
                        os.unlink(path)
                        orphans += 1
                    except OSError:
                        pass
        orphans += self._clear_tmp()
        # The journal is folded into the manifest and the filesystem:
        # truncate it so it cannot grow across restarts.
        if os.path.exists(self.journal_path):
            self._atomic_write(self.journal_path, b"")
        if replays or orphans:
            telemetry.COUNTERS.bump("persist_journal_replays", replays)
            telemetry.COUNTERS.bump("persist_sweep_orphans", orphans)
            telemetry.instant("persist_sweep", cat="serve",
                              journal_replays=replays, orphans=orphans)
        return {"journal_replays": replays, "orphans": orphans}, manifest

    def _read_journal(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        if not os.path.exists(self.journal_path):
            return out
        with open(self.journal_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # the torn last line of a crashed append
        return out

    def probe_record(self, universe: str,
                     generation: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
        """The committed parity probe of a universe's generation (newest
        by default): ``{generation, month, firm_idx, scores}``, or None
        when absent or unreadable. Read-only: the fleet's join gate
        scores this month through a candidate member."""
        manifest = self.load_manifest(quarantine=False) or {}
        gens = (manifest.get("universes", {}).get(universe)
                or {}).get("generations", [])
        if generation is None:
            rec = max(gens, key=lambda g: int(g["generation"]),
                      default=None)
        else:
            rec = next((g for g in gens
                        if int(g["generation"]) == int(generation)), None)
        if rec is None:
            return None
        try:
            with np.load(os.path.join(self.root, rec["dir"], "probe.npz"),
                         allow_pickle=False) as z:
                return {"generation": int(rec["generation"]),
                        "month": int(z["month"]),
                        "firm_idx": z["firm_idx"].copy(),
                        "scores": z["scores"].copy()}
        except (OSError, KeyError, ValueError):
            return None

    # ---- restore -----------------------------------------------------

    def restore_into(self, service: Any, warm: bool = True,
                     only_newer: bool = False) -> List[Dict[str, Any]]:
        """Re-register every committed universe into ``service``'s zoo,
        newest generation first with older-generation fallback, each
        verified (panel hash, params checksum, bitwise probe) before it
        may serve. Returns one info dict per restored universe; a
        universe whose every generation fails restores NOTHING (loud
        warning: the fresh-retrain fallback).

        ``only_newer`` is the fleet's sync: only generations strictly
        beyond what the service serves are considered (the manifest's
        generation is the fence a member catches up to)."""
        t0 = time.perf_counter()
        out: List[Dict[str, Any]] = []
        with telemetry.span("zoo_restore", cat="serve") as sp:
            swept, manifest = self._sweep_impl(quarantine=True)
            if not manifest:
                sp.set(universes=0, **swept)
                return out
            served_gens = service.zoo.snapshot()["universes"]
            for universe in sorted(manifest.get("universes", {})):
                gens = manifest["universes"][universe].get("generations", [])
                if only_newer:
                    served = int(served_gens.get(universe, -1))
                    gens = [g for g in gens
                            if int(g["generation"]) > served]
                    if not gens:
                        continue  # already at (or past) the fence
                restored = None
                for rec in sorted(gens, key=lambda g: -g["generation"]):
                    try:
                        restored = self._restore_generation(
                            service, universe, rec, warm=warm)
                        break
                    except Exception as e:  # noqa: BLE001 — ladder rung
                        # Quarantine only on an explicit verdict: a
                        # SnapshotIntegrityError not flagged as already
                        # quarantined or environmental. Anything else
                        # fails this attempt loudly and falls back.
                        verdict = isinstance(e, SnapshotIntegrityError)
                        if verdict and not (e.artifact_quarantined
                                            or e.skip_quarantine):
                            self._quarantine(
                                os.path.join(self.root, rec["dir"]), str(e))
                        elif not verdict:
                            warnings.warn(
                                f"durable zoo: {universe}/gen"
                                f"{rec.get('generation')}: restore "
                                f"attempt failed ({type(e).__name__}: "
                                f"{e}) — snapshot NOT quarantined "
                                "(undiagnosed failure, not corruption "
                                "evidence); falling back",
                                RuntimeWarning, stacklevel=2)
                        elif e.skip_quarantine:
                            warnings.warn(f"durable zoo: {e}",
                                          RuntimeWarning, stacklevel=2)
                        telemetry.COUNTERS.bump("restore_integrity_failures")
                        continue
                if restored is None:
                    warnings.warn(
                        f"durable zoo: universe {universe!r} restored "
                        "NOTHING (every committed generation failed "
                        "verification) — degrading to fresh retrain "
                        "rather than serving wrong numbers",
                        RuntimeWarning, stacklevel=2)
                    continue
                out.append(restored)
            sp.set(universes=len(out),
                   wall_s=round(time.perf_counter() - t0, 3), **swept)
        return out

    def _restore_generation(self, service: Any, universe: str,
                            rec: Dict[str, Any], warm: bool
                            ) -> Dict[str, Any]:
        """One generation's verify-then-serve ladder. A failing rung
        raises :class:`SnapshotIntegrityError` (the caller quarantines
        and falls back)."""
        import torch

        from lfm_quant_tpu_torch.config import RunConfig
        from lfm_quant_tpu_torch.data.panel import PanelSplits
        from lfm_quant_tpu_torch.serve.zoo import ZooEntry
        from lfm_quant_tpu_torch.utils import metrics

        t0 = time.perf_counter()
        gen = int(rec["generation"])
        gdir = os.path.join(self.root, rec["dir"])

        # 1. Panel: its content hash must match the manifest. A bad panel
        # is an ARTIFACT failure: the file itself is quarantined and the
        # generation dirs that share it stay in place.
        panel_path = os.path.join(self.root, rec["panel_file"])
        try:
            with open(panel_path, "rb") as fh:
                pbytes = fh.read()
        except OSError as e:
            err = SnapshotIntegrityError(
                f"{universe}/gen{gen}: panel file missing ({e})")
            err.artifact_quarantined = True  # nothing else to rename
            raise err
        if hashlib.sha256(pbytes).hexdigest() != rec["panel_sha256"]:
            reason = (f"{universe}/gen{gen}: panel content hash mismatch "
                      f"({rec['panel_file']})")
            self._quarantine(panel_path, reason)
            err = SnapshotIntegrityError(reason)
            err.artifact_quarantined = True
            raise err
        panel = _panel_from_npz(panel_path)

        # 2. The recorded config and boundaries.
        try:
            cfg = RunConfig.from_json(json.dumps(rec["cfg"]))
            splits = PanelSplits(
                panel=panel,
                train_end_idx=rec["splits"]["train_end_idx"],
                val_end_idx=rec["splits"]["val_end_idx"],
                train_start_idx=rec["splits"]["train_start_idx"])
            kind = rec.get("trainer", "Predictor")
            if kind not in _TRAINER_KINDS:
                raise ValueError(
                    f"snapshot records unsupported trainer kind {kind!r} "
                    f"(supported: {', '.join(_TRAINER_KINDS)})")
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: recorded config/splits do not "
                f"rebuild a trainer ({type(e).__name__}: {e})")

        # 3. Params and their checksum.
        try:
            saved = torch.load(os.path.join(gdir, "params.pt"),
                               map_location="cpu", weights_only=True)
            params = {k: v.numpy() for k, v in saved.items()}
        except Exception as e:  # noqa: BLE001 — integrity rung
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: params file unreadable "
                f"({type(e).__name__}: {e})")
        if params_checksum(params) != rec["params_sha256"]:
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: params checksum mismatch — the "
                "snapshot does not hold the bytes the manifest stamped")

        # 4. The scoring object on the service's device: the panel's one
        # upload. Params that do not fit the recorded model are a
        # verdict; any other failure here is the environment's.
        try:
            predictor = _build_trainer(kind, cfg, splits, params,
                                       service.device)
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: params do not fit the recorded "
                f"model ({type(e).__name__}: {e})")
        except Exception as e:  # noqa: BLE001 — environmental
            err = SnapshotIntegrityError(
                f"{universe}/gen{gen}: could not place the generation on "
                f"the device ({type(e).__name__}: {e}) — snapshot NOT "
                "quarantined (environmental failure, retry the restore)")
            err.skip_quarantine = True
            raise err from e
        entry = ZooEntry(universe, gen, predictor)

        # 5. The parity probe, bitwise, before the warm ladder.
        try:
            with np.load(os.path.join(gdir, "probe.npz"),
                         allow_pickle=False) as z:
                p_month = int(z["month"])
                p_pool = z["firm_idx"]
                p_scores = z["scores"]
        except (OSError, KeyError, ValueError) as e:
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: probe artifact unreadable "
                f"({type(e).__name__}: {e})")
        try:
            live_pool = entry.pool(entry.month_col(p_month))
            live = score_single_month(entry, p_month, service.max_rows)
        except KeyError:
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: probe month {p_month} is not "
                "serveable on the rebuilt entry — snapshot and code "
                "disagree about the universe's geometry")
        except Exception as e:  # noqa: BLE001 — environmental, not corrupt
            err = SnapshotIntegrityError(
                f"{universe}/gen{gen}: parity probe could not run "
                f"({type(e).__name__}: {e}) — snapshot NOT quarantined "
                "(environmental failure, retry the restore)")
            err.skip_quarantine = True
            raise err from e
        if not np.array_equal(live_pool, p_pool) or \
                not np.array_equal(live.astype(np.float32), p_scores):
            raise SnapshotIntegrityError(
                f"{universe}/gen{gen}: parity probe mismatch — month "
                f"{p_month} scored through the restored generation is "
                "NOT bit-equal to the publish-time probe")
        telemetry.COUNTERS.bump("restore_probe_ok")

        # 6+. Verified: a failure past here is the environment's and
        # never condemns the snapshot.
        try:
            if warm:
                service.warmup_entry(entry)
            # 7. The drift reference from the serialized sketch. A bad
            # sketch costs the drift gauge, not the verified generation.
            if rec.get("ref_sketch") and metrics.enabled():
                try:
                    entry.stamp_reference(
                        metrics.ScoreSketch.from_state(rec["ref_sketch"]))
                except (KeyError, TypeError, ValueError) as e:
                    warnings.warn(
                        f"durable zoo: {universe}/gen{gen}: drift "
                        f"reference sketch unreadable ({e}) — serving "
                        "WITHOUT a drift reference for this generation",
                        RuntimeWarning, stacklevel=2)
            service.zoo.publish(entry)
        except Exception as e:  # noqa: BLE001 — environmental, not corrupt
            err = SnapshotIntegrityError(
                f"{universe}/gen{gen}: post-verification restore step "
                f"failed ({type(e).__name__}: {e}) — snapshot NOT "
                "quarantined (it verified bit-equal; the failure is "
                "environmental)")
            err.skip_quarantine = True
            raise err from e
        info = {"universe": universe, "generation": gen,
                "probe": "bit_equal",
                "wall_s": round(time.perf_counter() - t0, 3)}
        telemetry.instant("restore_generation", cat="serve", **info)
        return info
