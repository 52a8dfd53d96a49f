"""The port's durable serving state (``serve/persist.py``) against the
JAX package's, and its own crash-consistency pins.

* Parity with ``lfm_quant_tpu/serve/persist.py`` on the same numpy
  inputs: ``params_checksum`` gives JAX's hex digest for params carried
  across, ``_panel_npz_bytes`` JAX's bytes, and the manifest's generation
  records and the journal's lines have JAX's keys. A port service
  restored from its store scores as the JAX service does (f32 atol 1e-5,
  ``tests/test_torch_serve.py``'s tolerance).
* The port's own pins, in place of JAX's
  ``test_publish_restore_roundtrip_bit_equal`` (which fails on the
  reference over an XLA trace count): restored scores BITWISE equal to
  the publish-time probe and to the scores served before the process
  died; 0 kernel builds and one panel upload per universe.
* Every quarantine case of ``tests/test_durable.py``, retention and the
  sweep, both publish fault sites, a same-generation republish, and one
  real SIGKILL mid-publish in a subprocess: an old or a new committed
  generation, never a torn one; no environmental failure quarantines.
* ``LFM_ZOO_PERSIST`` unset: no store, the same scores, counters and
  dispatches.
* ``scripts/trace_report.py`` renders the port's restore section.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from lfm_quant_tpu.config import (DataConfig, ModelConfig, OptimConfig,
                                  RunConfig)
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.windows import clear_panel_cache
from lfm_quant_tpu.serve import ScoringService as JaxService
from lfm_quant_tpu.serve import persist as jax_persist
from lfm_quant_tpu.serve.stats import load_trace_report
from lfm_quant_tpu.train import reuse
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.utils import faults as jax_faults
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.serve import ScoringService, ZooStore, persist
from lfm_quant_tpu_torch.serve.buckets import bucket_rows, bucket_width
from lfm_quant_tpu_torch.utils import faults, telemetry
from lfm_quant_tpu_torch.weights import flatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANEL = dict(n_firms=40, n_months=100, n_features=4, seed=5)
SPLIT = (197401, 197601)
F32 = dict(atol=1e-5, rtol=0.0)


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """No persist knob, no fault schedule, fresh counters, in and out."""
    for knob in ("LFM_ZOO_PERSIST", "LFM_ZOO_KEEP_GENERATIONS",
                 "LFM_FAULTS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("LFM_ASYNC", "0")

    def fresh():
        faults.configure("")
        jax_faults.configure("")
        telemetry.COUNTERS.reset()
        reuse.clear_program_cache()
        clear_panel_cache()

    fresh()
    yield
    fresh()


def _cfg(kind="lstm", seed=0):
    model = ModelConfig(kind=kind, kwargs={"hidden": 8 if kind == "lstm"
                                           else (8,)})
    return RunConfig(
        name="durable_t",
        data=DataConfig(n_firms=PANEL["n_firms"], n_months=PANEL["n_months"],
                        n_features=PANEL["n_features"], window=6,
                        dates_per_batch=2, firms_per_date=8),
        model=model,
        optim=OptimConfig(lr=3e-3, epochs=1, warmup_steps=2, loss="mse"),
        seed=seed)


def _jax_trainer(kind="lstm", seed=0):
    trainer = JaxTrainer(_cfg(kind, seed),
                         JaxSplits.by_date(jax_synthetic(**PANEL), *SPLIT))
    trainer.state = trainer.init_state()
    return trainer


_PARAMS = {}


def _params(kind="lstm", seed=0):
    """The JAX trainer's init params as numpy (memoized: the JAX init is
    the slow part)."""
    if (kind, seed) not in _PARAMS:
        tr = _jax_trainer(kind, seed)
        _PARAMS[kind, seed] = jax.tree_util.tree_map(np.asarray,
                                                     tr.state.params)
    return _PARAMS[kind, seed]


def _service(store_dir=None, **kw):
    kw.setdefault("max_rows", 2)
    kw.setdefault("max_wait_ms", 0.0)
    return ScoringService(device="cpu", persist_dir=store_dir, **kw)


def _register(svc, seed=0, universe="us"):
    tcfg = tconfig.RunConfig.from_json(_cfg(seed=seed).to_json())
    return svc.register(universe, tcfg, synthetic_panel(**PANEL),
                        _params(seed=seed))


def _publish(store_dir, seeds=(0,)):
    """Publish one generation per seed; returns (month, the last
    generation's scores of it)."""
    svc = _service(store_dir)
    try:
        for seed in seeds:
            _register(svc, seed)
        m = svc.serveable_months("us")[5]
        ref = svc.score("us", m).scores.copy()
    finally:
        svc.close()
    return m, ref


def _manifest(store_dir):
    with open(os.path.join(store_dir, "manifest.json")) as fh:
        return json.load(fh)


def _tamper_manifest(store_dir, fn):
    path = os.path.join(store_dir, "manifest.json")
    out = fn(_manifest(store_dir))
    with open(path, "w") as fh:
        fh.write(out if isinstance(out, str) else json.dumps(out))


# ---- parity with the JAX package ----------------------------------------


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_params_checksum_matches_jax(kind):
    params = _params(kind)
    want = jax_persist.params_checksum(params)
    assert persist.params_checksum(params) == want
    assert persist.params_checksum(flatten_params(params)) == want
    # Through the port's model: the host copy of the loaded params.
    svc = _service()
    try:
        tcfg = tconfig.RunConfig.from_json(_cfg(kind).to_json())
        entry = svc.register("us", tcfg, synthetic_panel(**PANEL), params,
                             warm=False)
        host = persist.host_params(entry.predictor.model)
        assert persist.params_checksum(host) == want
    finally:
        svc.close()


@pytest.mark.parametrize("ret_valid", [True, False])
def test_panel_npz_bytes_match_jax(tmp_path, ret_valid):
    import dataclasses

    jp, tp = jax_synthetic(**PANEL), synthetic_panel(**PANEL)
    if not ret_valid:
        jp = dataclasses.replace(jp, ret_valid=None)
        tp = dataclasses.replace(tp, ret_valid=None)
    got = persist._panel_npz_bytes(tp)
    assert got == jax_persist._panel_npz_bytes(jp)
    path = tmp_path / "panel.npz"
    path.write_bytes(got)
    back = persist._panel_from_npz(str(path))
    assert persist._panel_npz_bytes(back) == got


def test_records_and_restored_scores_match_jax(tmp_path):
    """One publish in each package: the same record and journal keys,
    the same params and panel digests; the port restored from its store
    scores as the JAX service does."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsvc = JaxService(max_rows=2, max_wait_ms=0.0, persist_dir=jdir)
    try:
        jsvc.register("us", _jax_trainer())
        months = jsvc.serveable_months("us")[::9]
        jscores = {m: np.asarray(jsvc.score("us", m).scores)
                   for m in months}
    finally:
        jsvc.close()
    svc = _service(tdir)
    try:
        _register(svc)
    finally:
        svc.close()
    jm, tm = _manifest(jdir), _manifest(tdir)
    assert set(tm) - {"torch"} == set(jm) - {"jax"}
    jrec = jm["universes"]["us"]["generations"][0]
    trec = tm["universes"]["us"]["generations"][0]
    assert set(trec) == set(jrec)
    assert trec["params_sha256"] == jrec["params_sha256"]
    assert trec["panel_sha256"] == jrec["panel_sha256"]
    assert trec["cfg"] == jrec["cfg"]
    assert trec["generation"] == jrec["generation"] == 0
    # The journals: one begin and one commit line each, JAX's keys (the
    # attach sweep truncates a journal, so read them before a restore).
    jj = [json.loads(x) for x in open(os.path.join(jdir, "journal.jsonl"))]
    tj = [json.loads(x) for x in open(os.path.join(tdir, "journal.jsonl"))]
    assert [(x["state"], sorted(x)) for x in tj] == \
        [(x["state"], sorted(x)) for x in jj]

    svc2 = _service(tdir)
    try:
        restored = svc2.restore()
        assert [r["probe"] for r in restored] == ["bit_equal"]
        for m, want in jscores.items():
            np.testing.assert_allclose(svc2.score("us", m).scores, want,
                                       **F32)
    finally:
        svc2.close()


# ---- the round trip, bitwise ---------------------------------------------


@pytest.mark.parametrize("published_by", ["register", "refresh"])
def test_restore_is_bitwise_the_published_generation(tmp_path,
                                                     published_by):
    store_dir = str(tmp_path / "store")
    svc = _service(store_dir)
    try:
        _register(svc)
        if published_by == "refresh":
            entry = svc.zoo.current("us")
            svc.refresh("us", PanelSplits.by_date(entry.panel, *SPLIT),
                        epochs=1)
        gen = svc.zoo.current("us").generation
        months = svc.serveable_months("us")
        picked = (months[3], months[len(months) // 2], months[-1])
        refs = {m: svc.score("us", m).scores.copy() for m in picked}
        had_sketch = svc.zoo.current("us").ref_sketch is not None
        kind = type(svc.zoo.current("us").predictor).__name__
    finally:
        svc.close()
    rec = _manifest(store_dir)["universes"]["us"]["generations"][-1]
    assert rec["trainer"] == kind
    assert rec["execs"] == {}
    assert set(rec["program_fingerprint"]) == {"torch", "cuda", "device",
                                               "kernels"}

    svc2 = _service(store_dir)
    try:
        restored = svc2.restore()
        assert [(r["universe"], r["generation"], r["probe"])
                for r in restored] == [("us", gen, "bit_equal")]
        assert svc2.last_restore_compiles == 0
        assert svc2.last_restore_panel_h2d == 1
        for m, ref in refs.items():
            np.testing.assert_array_equal(svc2.score("us", m).scores, ref)
        probe = svc2.store.probe_record("us")
        entry = svc2.zoo.current("us")
        np.testing.assert_array_equal(
            persist.score_single_month(entry, probe["month"],
                                       svc2.max_rows), probe["scores"])
        assert type(entry.predictor).__name__ == kind
        if had_sketch:
            assert entry.ref_sketch is not None
            assert entry.live_sketch is not None
    finally:
        svc2.close()


def test_score_single_month_is_the_served_path():
    svc = _service()
    try:
        _register(svc)
        m = svc.serveable_months("us")[7]
        served = svc.score("us", m)
        probe = persist.score_single_month(svc.zoo.current("us"), m,
                                           svc.max_rows)
        np.testing.assert_array_equal(probe, served.scores)
    finally:
        svc.close()


def _dispatch(entry, months, rows):
    """A ``[rows, width]`` scoring dispatch of ``months`` as the batcher
    builds it (pads repeat the last firm and row 0 at weight 0)."""
    pools = [(entry.month_col(m), entry.pool(entry.month_col(m)))
             for m in months]
    width = bucket_width(max(p.size for _, p in pools))
    fi = np.zeros((rows, width), np.int32)
    ti = np.zeros((rows,), np.int32)
    w = np.zeros((rows, width), np.float32)
    for i, (t, pool) in enumerate(pools):
        fi[i, :pool.size], fi[i, pool.size:] = pool, pool[-1]
        ti[i], w[i, :pool.size] = t, 1.0
    for i in range(len(pools), rows):
        fi[i], ti[i] = fi[0], ti[0]
    return entry.score(fi, ti, w)


def test_served_scores_are_batch_invariant():
    """A month's served scores are the same bits alone (the probe's
    geometry) and coalesced with other months at any row count and
    position: the head's output product sums in one fixed order under
    inference (``models/heads.py ordered_dense``)."""
    svc = _service(max_rows=8)
    try:
        _register(svc)
        entry = svc.zoo.current("us")
        months = svc.serveable_months("us")
        picked = months[::max(1, len(months) // 6)]
        for m in picked:
            alone = persist.score_single_month(entry, m, svc.max_rows)
            n = alone.size
            others = [o for o in picked if o != m
                      and bucket_width(entry.pool(entry.month_col(o)).size)
                      == bucket_width(n)] or [m]
            for real in (2, 3, 8):
                co = (others * 8)[:real - 1]
                for pos in (0, real - 1):
                    batch = co[:pos] + [m] + co[pos:]
                    got = _dispatch(entry, batch, bucket_rows(real, 8))
                    np.testing.assert_array_equal(got[pos, :n], alone)
    finally:
        svc.close()


def test_persist_off_is_an_exact_noop(monkeypatch, tmp_path):
    assert persist.persist_dir_default() is None
    assert not persist.persist_enabled()
    monkeypatch.setenv("LFM_ZOO_PERSIST", "0")
    assert persist.persist_dir_default() is None
    monkeypatch.setenv("LFM_ZOO_PERSIST", str(tmp_path / "store"))
    assert persist.persist_dir_default() == str(tmp_path / "store")
    assert persist.persist_enabled()
    monkeypatch.delenv("LFM_ZOO_PERSIST")
    monkeypatch.setenv("LFM_ZOO_KEEP_GENERATIONS", "5")
    assert persist.keep_generations_default() == 5
    monkeypatch.delenv("LFM_ZOO_KEEP_GENERATIONS")
    assert persist.keep_generations_default() == 2

    def served(store_dir):
        telemetry.COUNTERS.reset()
        _build.reset_launch_counts()
        svc = _service(store_dir)
        try:
            _register(svc)
            months = svc.serveable_months("us")[:6]
            scores = [svc.score("us", m).scores for m in months]
            return (svc.store, scores, svc.stats()["batches"],
                    _build.launch_counts(), telemetry.COUNTERS.snapshot())
        finally:
            svc.close()

    store_off, off, batches_off, launches_off, counters_off = served(None)
    assert store_off is None
    assert not any(k.startswith(("persist_", "restore_"))
                   for k in counters_off)
    store_on, on, batches_on, launches_on, counters_on = served(
        str(tmp_path / "store"))
    assert store_on is not None and counters_on["persist_commits"] == 1
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert batches_off == batches_on and launches_off == launches_on
    assert os.listdir(tmp_path) == ["store"]


# ---- integrity: the quarantine ladder --------------------------------------


def _flip_checksum(store_dir):
    def flip(m):
        m["universes"]["us"]["generations"][-1]["params_sha256"] = "0" * 64
        return m

    _tamper_manifest(store_dir, flip)


def _flip_probe(store_dir):
    path = os.path.join(store_dir, "universes", "us", "gen_00001",
                        "probe.npz")
    with np.load(path, allow_pickle=False) as z:
        month, fi, scores = int(z["month"]), z["firm_idx"], z["scores"]
    np.savez(path, month=np.asarray(month, np.int64), firm_idx=fi,
             scores=scores + np.float32(1e-3))


def _flip_panel(store_dir):
    udir = os.path.join(store_dir, "universes", "us")
    name = next(f for f in os.listdir(udir) if f.startswith("panel_"))
    blob = bytearray(open(os.path.join(udir, name), "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(os.path.join(udir, name), "wb") as fh:
        fh.write(bytes(blob))


def _flip_params(store_dir):
    path = os.path.join(store_dir, "universes", "us", "gen_00001",
                        "params.pt")
    with open(path, "wb") as fh:
        fh.write(b"not a torch file")


# case → (tamper, what restores, where the quarantined artifact lands)
LADDER = {
    "future_schema": (lambda d: _tamper_manifest(
        d, lambda m: dict(m, schema_version=99)), [], ""),
    "truncated_manifest": (lambda d: _tamper_manifest(
        d, lambda m: json.dumps(m)[:40]), [], ""),
    "params_checksum": (_flip_checksum, [0], "universes/us"),
    "params_unreadable": (_flip_params, [0], "universes/us"),
    "probe_mismatch": (_flip_probe, [0], "universes/us"),
    "shared_panel": (_flip_panel, [], "universes/us"),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_quarantine_ladder(tmp_path, case):
    """Each corruption is quarantined loudly and the restore falls back
    to the next-older committed generation (gen 0, published with other
    params) or to nothing; never to the corrupt generation's numbers. A
    corrupt manifest's snapshots, and a corrupt shared panel's generation
    dirs, stay in place as evidence."""
    store_dir = str(tmp_path / "store")
    m, gen1_scores = _publish(store_dir, seeds=(0, 1))
    tamper, want, where = LADDER[case]
    tamper(store_dir)
    svc = _service(store_dir)
    try:
        with pytest.warns(RuntimeWarning, match="QUARANTINED"):
            restored = svc.restore()
        assert [r["generation"] for r in restored] == want
        qdir = os.path.join(store_dir, where)
        assert any(".quarantined." in f for f in os.listdir(qdir))
        if want:
            r = svc.score("us", m)
            assert r.generation == 0
            assert not np.array_equal(r.scores, gen1_scores)
        else:
            assert svc.zoo.universes() == []
    finally:
        svc.close()
    udir = os.path.join(store_dir, "universes", "us")
    if case in ("future_schema", "truncated_manifest", "shared_panel"):
        assert {"gen_00000", "gen_00001"} <= set(os.listdir(udir))
    assert telemetry.COUNTERS.get("persist_quarantines") >= 1
    if where:  # a generation failed its ladder (not the manifest)
        assert telemetry.COUNTERS.get("restore_integrity_failures") >= 1


def test_publish_refuses_over_unreadable_manifest(tmp_path):
    store_dir = str(tmp_path / "store")
    _publish(store_dir)
    _tamper_manifest(store_dir, lambda m: "{ this is not json")
    svc = _service(store_dir)
    try:
        for seed in (9, 10):  # not one-shot: it keeps refusing
            with pytest.raises(RuntimeError, match="refusing to publish"):
                _register(svc, seed)
            assert os.path.exists(os.path.join(store_dir, "manifest.json"))
    finally:
        svc.close()
    assert os.path.isdir(os.path.join(store_dir, "universes", "us",
                                      "gen_00000"))


def test_environmental_failure_never_quarantines(tmp_path):
    """A device fault while the generation is placed (the panel upload)
    fails the attempt loudly and condemns nothing: the healed retry
    restores bitwise."""
    store_dir = str(tmp_path / "store")
    m, ref = _publish(store_dir)
    svc = _service(store_dir)
    try:
        faults.configure("panel_h2d:n=1,kind=permanent")
        with pytest.warns(RuntimeWarning, match="NOT quarantined"):
            assert svc.restore() == []
        faults.configure("")
        udir = os.path.join(store_dir, "universes", "us")
        assert not any(".quarantined." in f for f in os.listdir(udir))
        assert [r["generation"] for r in svc.restore()] == [0]
        np.testing.assert_array_equal(svc.score("us", m).scores, ref)
    finally:
        svc.close()


# ---- retention / sweep ---------------------------------------------------


def test_retention_prunes_superseded_generations(tmp_path):
    store_dir = str(tmp_path / "store")
    svc = _service(store_dir, keep_generations=2)
    try:
        for seed in range(3):  # gens 0, 1, 2
            _register(svc, seed)
    finally:
        svc.close()
    udir = os.path.join(store_dir, "universes", "us")
    gens = sorted(f for f in os.listdir(udir) if f.startswith("gen_"))
    assert gens == ["gen_00001", "gen_00002"]
    assert [g["generation"] for g in _manifest(store_dir)["universes"]["us"]
            ["generations"]] == [1, 2]
    assert telemetry.COUNTERS.get("persist_gc_pruned") == 1
    svc2 = _service(store_dir)
    try:
        assert [r["generation"] for r in svc2.restore()] == [2]
    finally:
        svc2.close()


def test_sweep_reclaims_orphans_and_replays_journal(tmp_path):
    store_dir = str(tmp_path / "store")
    _publish(store_dir)
    store = ZooStore(store_dir)
    orphan_rel = os.path.join("universes", "us", "gen_00007")
    os.makedirs(os.path.join(store_dir, orphan_rel))
    store._journal({"op": "publish", "universe": "us", "generation": 7,
                    "dir": orphan_rel, "state": "begin", "ts": 0.0})
    with open(os.path.join(store_dir, "tmp", "leftover.bin"), "wb") as fh:
        fh.write(b"x" * 16)
    out = store.sweep()
    assert out["journal_replays"] == 1
    assert out["orphans"] >= 2
    assert not os.path.exists(os.path.join(store_dir, orphan_rel))
    assert os.listdir(os.path.join(store_dir, "tmp")) == []
    assert os.path.getsize(store.journal_path) == 0
    assert os.path.isdir(os.path.join(store_dir, "universes", "us",
                                      "gen_00000"))
    assert store.sweep() == {"journal_replays": 0, "orphans": 0}


# ---- the fault sites --------------------------------------------------------


@pytest.mark.parametrize("spec,want_gen", [
    ("zoo_persist:at=0,kind=permanent", 0),     # before staging
    ("manifest_write:at=0,kind=permanent", 0),  # before the rename
    ("manifest_write:at=1,kind=permanent", 1),  # after the rename
])
def test_publish_fault_leaves_a_committed_generation(tmp_path, spec,
                                                     want_gen):
    """A publish that dies before the manifest rename commits nothing;
    one that dies after it is committed although the journal's commit
    line and the in-memory swap never ran: the manifest is the one
    commit point."""
    store_dir = str(tmp_path / "store")
    m, ref = _publish(store_dir)
    svc = _service(store_dir)
    try:
        svc.restore()
        faults.configure(spec)
        with pytest.raises(faults.PermanentFault):
            _register(svc, seed=9)
        faults.configure("")
        assert svc.zoo.current("us").generation == 0  # never swapped
    finally:
        svc.close()
    svc2 = _service(store_dir)
    try:
        restored = svc2.restore()
        assert [(r["generation"], r["probe"]) for r in restored] == \
            [(want_gen, "bit_equal")]
        if want_gen == 0:
            np.testing.assert_array_equal(svc2.score("us", m).scores, ref)
    finally:
        svc2.close()


def test_same_generation_republish_never_guts_committed_snapshot(tmp_path):
    store_dir = str(tmp_path / "store")
    m, ref = _publish(store_dir)
    # A crashed republish of gen 0 with other params, before the rename.
    svc = _service(store_dir)
    try:
        faults.configure("manifest_write:at=0,kind=permanent")
        with pytest.raises(faults.PermanentFault):
            _register(svc, seed=9)
        faults.configure("")
    finally:
        svc.close()
    svc2 = _service(store_dir)
    try:
        assert [r["generation"] for r in svc2.restore()] == [0]
        np.testing.assert_array_equal(svc2.score("us", m).scores, ref)
    finally:
        svc2.close()
    # A clean republish of gen 0 supersedes it; the old dir is reclaimed.
    svc3 = _service(store_dir)
    try:
        _register(svc3, seed=9)
        new_ref = svc3.score("us", m).scores.copy()
    finally:
        svc3.close()
    assert not np.array_equal(new_ref, ref)
    udir = os.path.join(store_dir, "universes", "us")
    assert len([f for f in os.listdir(udir) if f.startswith("gen_")]) == 1
    svc4 = _service(store_dir)
    try:
        assert [r["generation"] for r in svc4.restore()] == [0]
        np.testing.assert_array_equal(svc4.score("us", m).scores, new_ref)
    finally:
        svc4.close()


_CHILD = """\
import sys
sys.path.insert(0, sys.argv[2])
import numpy as np
from lfm_quant_tpu_torch.config import RunConfig
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.serve import ScoringService

store_dir, cfg_json, params_npz = sys.argv[1], sys.argv[3], sys.argv[4]
with np.load(params_npz) as z:
    params = {k: z[k] for k in z.files}
svc = ScoringService(device="cpu", max_rows=2, max_wait_ms=0.0,
                     persist_dir=store_dir)
assert [r["generation"] for r in svc.restore()] == [0]
svc.register("us", RunConfig.from_json(open(cfg_json).read()),
             synthetic_panel(n_firms=40, n_months=100, n_features=4, seed=5),
             params)  # the SIGKILL lands inside this publish
svc.close()
print("PUBLISHED")
"""


def test_sigkill_mid_publish_subprocess_keeps_the_old_generation(tmp_path):
    """A real subprocess SIGKILLed (no handler, no cleanup) at the
    manifest's commit point while it publishes generation 1 over 0: the
    restore serves generation 0, verified bitwise, and the sweep leaves
    no gen dir the manifest does not name."""
    store_dir = str(tmp_path / "store")
    m, ref = _publish(store_dir)
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(_cfg(seed=9).to_json())
    params_npz = tmp_path / "params.npz"
    np.savez(params_npz, **flatten_params(_params(seed=9)))
    env = dict(os.environ, LFM_FAULTS="manifest_write:at=0,kind=sigkill",
               OMP_NUM_THREADS="1")
    env.pop("LFM_ZOO_PERSIST", None)
    out = subprocess.run(
        [sys.executable, str(script), store_dir, REPO, str(cfg_json),
         str(params_npz)], env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == -signal.SIGKILL, (out.returncode,
                                               out.stderr[-800:])
    assert "PUBLISHED" not in out.stdout
    svc = _service(store_dir)
    try:
        restored = svc.restore()
        assert [(r["generation"], r["probe"]) for r in restored] == \
            [(0, "bit_equal")]
        np.testing.assert_array_equal(svc.score("us", m).scores, ref)
        referenced = {os.path.basename(g["dir"]) for g in
                      _manifest(store_dir)["universes"]["us"]["generations"]}
        udir = os.path.join(store_dir, "universes", "us")
        on_disk = {f for f in os.listdir(udir) if f.startswith("gen_")}
        assert on_disk == referenced == {"gen_00000"}
        assert telemetry.COUNTERS.get("persist_journal_replays") == 1
    finally:
        svc.close()


# ---- observability ---------------------------------------------------------


def test_restore_section_in_trace_report(tmp_path):
    store_dir, run_dir = str(tmp_path / "store"), str(tmp_path / "run")
    _publish(store_dir)
    svc = _service(store_dir)
    try:
        with telemetry.run_scope(run_dir, extra={"entry": "test"}):
            restored = svc.restore()
    finally:
        svc.close()
    tr_mod = load_trace_report(REPO)
    rep = tr_mod.build_report(tr_mod.load_run(run_dir))
    rs = rep["restore"]
    assert rs["universes_restored"] == len(restored) == 1
    assert rs["restore_wall_s"] > 0
    assert rs["integrity"] == "bit_equal"
    assert rs["probes_ok"] == 1 and rs["integrity_failures"] == 0
    assert rs["execs_loaded"] == 0 and rs["execs_recompiled"] == 0
    assert rs["generations"][0]["universe"] == "us"
    assert rs["generations"][0]["probe"] == "bit_equal"


# ---- the serve entry point ---------------------------------------------------

CLI = ["--preset", "c1", "--n-firms", "40", "--n-months", "90",
       "--device", "cpu", "--requests", "4", "--threads", "2"]


def _cli_stats(capsys, argv):
    from lfm_quant_tpu_torch.serve.__main__ import main

    assert main(CLI + argv) == 0
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1])


def test_serve_cli_persist_then_restore(tmp_path, capsys):
    store = str(tmp_path / "store")
    first = _cli_stats(capsys, ["--persist", store])
    assert first["warmup_s"] is not None and "restored" not in first
    again = _cli_stats(capsys, ["--persist", store, "--restore"])
    assert [(r["generation"], r["probe"]) for r in again["restored"]] == \
        [(0, "bit_equal")]
    assert again["warmup_s"] is None  # nothing rebuilt
    assert again["restore_compiles"] == 0
    assert again["restore_panel_h2d"] == 1
    assert again["restore_s"] > 0 and again["first_response_ms"] > 0
    assert again["completed"] == 4


@pytest.mark.parametrize("argv,match", [
    (["--restore"], "--restore needs --persist"),
    (["--fleet", "2"], "--fleet needs --persist"),
    (["--fleet", "2", "--persist", "STORE", "--refresh"],
     "--refresh is not supported with --fleet"),
])
def test_serve_cli_argument_errors(tmp_path, capsys, argv, match):
    from lfm_quant_tpu_torch.serve.__main__ import main

    argv = [str(tmp_path / "s") if a == "STORE" else a for a in argv]
    with pytest.raises(SystemExit) as ei:
        main(CLI + argv)
    assert ei.value.code == 2
    assert match in capsys.readouterr().err
