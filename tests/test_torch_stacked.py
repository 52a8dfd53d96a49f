"""The port's stacked config sweeps (``train/stacked.py``) against the
JAX package's stacked engine and against the port's own sequential fits.

* ``run_config_sweep`` on an MLP LR × weight-decay grid against JAX
  ``run_config_sweep`` (the unsharded stack, ``LFM_STACK_SHARDS=0``, as
  its own tests run it), both from the JAX per-run init
  (``Trainer.init_stacked_states``, carried by ``weights.member_params``):
  per-config histories at rtol 2e-5, epochs run, best epoch and the
  ranking exact (``tests/test_stacked.py _assert_parity``'s non-exact
  branch: the JAX bitwise pins fail on the reference, ROADMAP Queue C).
* The same sweep and an LSTM sweep with divergent early stopping against
  the port's sequential fits (``stacked=False``): the CPU's batched
  products and per-member norms round differently from the single
  model's, so histories at rtol 2e-5 with every decision exact; each
  test reports whether the runs came out bitwise. A stopped run's params,
  moments and step stay bit-frozen while the others train.
* ``LFM_STACK_BLOCK`` is a pure re-batching (bitwise); a non-dividing
  block runs unblocked with a warning; each ``StackUnavailable`` raise,
  and the loud degrade (warning, ``stack_degrades``, ``stack_degraded``);
  ``parse_sweep_grid``; the per-member optimizer's step sizes;
  ``sweep_summary.json`` with its run dirs loading; the CLI.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.train.stacked import run_config_sweep as jax_sweep
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.train import stacked as ST
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.loop import default_split_dates, load_trainer
from lfm_quant_tpu_torch.train.optim import AdamW, make_optimizer
from lfm_quant_tpu_torch.utils import telemetry

PANEL = dict(n_firms=100, n_months=200, n_features=5, seed=5)
GRID = "lr=1e-3,3e-4;weight_decay=1e-4,0"
#: Histories against the JAX engine and the port's sequential fits.
RTOL = 2e-5
FIELDS = ("train_loss", "grad_norm", "val_ic", "val_mse")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    tier-1 run's workers share the machine's cores (more threads burn
    about three times the CPU for the same wall)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfg_mod, tmp, kind="mlp", epochs=2, patience=99, **optim):
    kwargs = {"hidden": (16,)} if kind == "mlp" else {"hidden": 8}
    return cfg_mod.RunConfig(
        name="cswp",
        data=cfg_mod.DataConfig(n_firms=100, n_months=200, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=32),
        model=cfg_mod.ModelConfig(kind=kind, kwargs=kwargs),
        optim=cfg_mod.OptimConfig(**{"lr": 1e-3, "epochs": epochs,
                                     "warmup_steps": 5, "loss": "mse",
                                     "early_stop_patience": patience,
                                     **optim}),
        seed=0, out_dir=str(tmp))


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(**PANEL)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX stacked sweep (unsharded) and its per-run init."""
    tmp = tmp_path_factory.mktemp("jax_stk")
    old = os.environ.get("LFM_STACK_SHARDS")
    os.environ["LFM_STACK_SHARDS"] = "0"
    try:
        jp = jax_synthetic(**PANEL)
        cfg = _cfg(jax_config, tmp)
        grid = ST.parse_sweep_grid(GRID)
        splits = JaxSplits.by_date(jp, *default_split_dates(jp, cfg.data))
        init = jax.tree_util.tree_map(np.asarray, JaxTrainer(
            cfg, splits).init_stacked_states([cfg.seed] * len(grid)).params)
        summary = jax_sweep(cfg, grid, panel=jp, out_dir=str(tmp / "out"),
                            stacked=True)
    finally:
        if old is None:
            os.environ.pop("LFM_STACK_SHARDS")
        else:
            os.environ["LFM_STACK_SHARDS"] = old
    return summary, str(tmp / "out"), init


@pytest.fixture(scope="module")
def port_stacked(jax_ref, panel, tmp_path_factory):
    """The port's stacked sweep of the same grid from the same init."""
    tmp = tmp_path_factory.mktemp("port_stk")
    out = str(tmp / "out")
    summary = ST.run_config_sweep(
        _cfg(config, tmp), ST.parse_sweep_grid(GRID), panel=panel,
        out_dir=out, stacked=True, device="cpu", init_params=jax_ref[2])
    return summary, out


def _histories(out_dir, n):
    return [[json.loads(line) for line in open(os.path.join(
        out_dir, f"config_{i:03d}", "metrics.jsonl"))] for i in range(n)]


def _assert_parity(got, want, rtol=RTOL):
    """Decisions exact, per-run histories at ``rtol``; returns whether
    every history field came out bitwise."""
    (sg, dg), (sw, dw) = got, want
    n = sw["n_configs"]
    assert sg["n_configs"] == n and sg["grid"] == sw["grid"]
    for rg, rw in zip(sg["runs"], sw["runs"]):
        assert rg["epochs_run"] == rw["epochs_run"], rw["config"]
        assert rg["best_epoch"] == rw["best_epoch"], rw["config"]
        np.testing.assert_allclose(rg["best_val_ic"], rw["best_val_ic"],
                                   rtol=rtol)
    assert sg["best_index"] == sw["best_index"]
    bitwise = True
    for i, (a, b) in enumerate(zip(_histories(dg, n), _histories(dw, n))):
        assert [r["epoch"] for r in a] == [r["epoch"] for r in b], i
        assert [r["step"] for r in a] == [r["step"] for r in b], i
        for ra, rb in zip(a, b):
            for f in FIELDS:
                if f in rb:
                    np.testing.assert_allclose(ra[f], rb[f], rtol=rtol,
                                               err_msg=f"config {i} {f}")
                    bitwise &= ra[f] == rb[f]
    return bitwise


def test_sweep_matches_the_jax_stacked_engine(jax_ref, port_stacked):
    """Per-config histories within rtol 2e-5 of the JAX stacked engine's,
    every decision exact; the stack summary as the JAX one names it."""
    _assert_parity(port_stacked, jax_ref[:2])
    info = port_stacked[0]["stacked"]
    assert info["enabled"] is True and info["kind"] == "config"
    assert info["run_count"] == 4 and info["hyper"] == list(ST.HYPER_KEYS)
    assert info["stack_mesh"] is None and info["stack_block"] == 0


def test_sweep_matches_the_sequential_fits(jax_ref, port_stacked, panel,
                                          tmp_path, monkeypatch, capsys):
    """The same grid one fit after another (``LFM_SWEEP_STACKED=0``, the
    reference) from the same init: rtol 2e-5, decisions exact; whether the
    CPU gave the same bits is printed. ``sweep_summary.json`` ranks the
    grid, and each config dir loads to the stack's best params."""
    monkeypatch.setenv("LFM_SWEEP_STACKED", "0")
    out = str(tmp_path / "seq")
    seq = ST.run_config_sweep(_cfg(config, tmp_path),
                              ST.parse_sweep_grid(GRID), panel=panel,
                              out_dir=out, device="cpu",
                              init_params=jax_ref[2])
    assert seq["stacked"] is None
    bitwise = _assert_parity(port_stacked, (seq, out))
    with capsys.disabled():
        print(f"\nstacked MLP sweep bitwise against its sequential fits: "
              f"{bitwise}")
    summary, stk = port_stacked
    on_disk = json.loads(open(os.path.join(stk, "sweep_summary.json")).read())
    assert on_disk["best_index"] == summary["best_index"] == int(np.argmax(
        [r["best_val_ic"] for r in summary["runs"]]))
    assert on_disk["best_config"] == summary["grid"][summary["best_index"]]
    for i in range(4):
        a, _ = load_trainer(os.path.join(stk, f"config_{i:03d}"),
                            panel=panel, device="cpu")
        b, _ = load_trainer(os.path.join(out, f"config_{i:03d}"),
                            panel=panel, device="cpu")
        assert a.cfg.optim.lr == summary["grid"][i]["lr"]
        for k, p in a.state.params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       b.state.params[k].detach().numpy(),
                                       rtol=1e-4, atol=5e-6, err_msg=k)


def test_lstm_divergent_early_stop_and_frozen_runs(panel, tmp_path,
                                                  monkeypatch, capsys):
    """An LSTM sweep (the plain versions of the seed-grid recurrence and
    the folded gather) whose configs stop at different epochs (patience
    1, lr 3e-2 against 1e-2): the stack against the sequential fits, and the
    stopped run's params, moments and step bit-frozen in every later
    epoch while a neighbour still trains."""
    cfg = dataclasses.replace(_cfg(config, tmp_path, kind="lstm", epochs=3,
                                   patience=1), seed=2)
    grid = ST.parse_sweep_grid("lr=3e-2,1e-2")
    seq = ST.run_config_sweep(cfg, grid, panel=panel, stacked=False,
                              out_dir=str(tmp_path / "seq"), device="cpu")
    epochs = [r["epochs_run"] for r in seq["runs"]]
    assert min(epochs) < 3 and len(set(epochs)) > 1, epochs

    seen = []
    orig = ST.StackedRuns.dispatch_epoch

    def record(self, carry, args):
        carry, vals = orig(self, carry, args)
        st = carry.state
        seen.append(([p.clone() for p in st.params.values()]
                     + [m.clone() for m in st.opt_state.mu.values()]
                     + [v.clone() for v in st.opt_state.nu.values()],
                     carry.ctrl.step.clone(), carry.ctrl.live.clone()))
        return carry, vals

    monkeypatch.setattr(ST.StackedRuns, "dispatch_epoch", record)
    stk = ST.run_config_sweep(cfg, grid, panel=panel, stacked=True,
                              out_dir=str(tmp_path / "stk"), device="cpu")
    bitwise = _assert_parity((stk, str(tmp_path / "stk")),
                             (seq, str(tmp_path / "seq")))
    with capsys.disabled():
        print(f"\nstacked LSTM sweep bitwise against its sequential fits: "
              f"{bitwise}")
    stopped = int(np.argmin(epochs))
    live = 1 - stopped
    e = epochs[stopped] - 1  # the epoch whose control stopped it
    assert not bool(seen[e][2][stopped]) and bool(seen[e][2][live])
    for later in seen[e + 1:]:
        assert all(torch.equal(a[stopped], b[stopped])
                   for a, b in zip(seen[e][0], later[0]))
        assert int(later[1][stopped]) == int(seen[e][1][stopped])
    assert not all(torch.equal(a[live], b[live])
                   for a, b in zip(seen[e][0], seen[e + 1][0]))


def test_stack_block_is_a_pure_rebatching(panel, monkeypatch):
    """``LFM_STACK_BLOCK=2`` on 4 runs steps 2 blocks of 2 runs: the
    same bits as the unblocked stack; a block of 3 does not divide 4 and
    runs unblocked with a warning."""
    cfg = _cfg(config, "runs", epochs=1)
    grid = ST.parse_sweep_grid(GRID)
    runs = [dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                               **g))
            for g in grid]
    splits = PanelSplits.by_date(panel, *default_split_dates(panel,
                                                             cfg.data))
    fits = {}
    for blk in ("0", "2"):
        monkeypatch.setenv("LFM_STACK_BLOCK", blk)
        eng = ST.StackedRuns(runs, [splits] * 4, panel, device="cpu")
        assert eng.stack_block == int(blk)
        sums, _ = eng.fit()
        fits[blk] = (sums, eng.run_state(0)["params"])
    for a, b in zip(fits["0"][0], fits["2"][0]):
        assert a["history"][0]["train_loss"] == b["history"][0]["train_loss"]
        assert a["history"][0]["val_ic"] == b["history"][0]["val_ic"]
    for k, p in fits["0"][1].items():
        assert torch.equal(p, fits["2"][1][k]), k
    monkeypatch.setenv("LFM_STACK_BLOCK", "3")
    with pytest.warns(UserWarning, match="does not divide"):
        eng = ST.StackedRuns(runs, [splits] * 4, panel, device="cpu")
    assert eng.stack_block == 0


def test_stack_unavailable_is_raised_and_degrades_loudly(panel, tmp_path,
                                                         monkeypatch):
    """Every precondition the stack cannot meet raises StackUnavailable;
    the sweep then degrades with a warning, the ``stack_degrades``
    counter and a ``stack_degraded`` instant, and trains sequentially."""
    cfg = _cfg(config, tmp_path, epochs=1)
    splits = PanelSplits.by_date(panel, *default_split_dates(panel,
                                                             cfg.data))
    two = [cfg, dataclasses.replace(cfg, seed=1)]
    with pytest.raises(ST.StackUnavailable, match=">= 2 runs"):
        ST.StackedRuns([cfg], [splits], panel, device="cpu")
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, kwargs={"hidden": (8,)}))
    with pytest.raises(ST.StackUnavailable, match="differs beyond"):
        ST.StackedRuns([cfg, wide], [splits] * 2, panel, device="cpu")
    ens = dataclasses.replace(cfg, n_seeds=2)
    with pytest.raises(ST.StackUnavailable, match="single-seed"):
        ST.StackedRuns([ens, dataclasses.replace(ens, optim=dataclasses.
                                                 replace(ens.optim, lr=0.1))],
                       [splits] * 2, panel, device="cpu")
    short = PanelSplits.by_date(panel, int(panel.dates[110]),
                                int(panel.dates[150]))
    with pytest.raises(ST.StackUnavailable, match="steps-per-epoch"):
        ST.StackedRuns(two, [splits, short], panel, device="cpu")
    train_end, _ = default_split_dates(panel, cfg.data)
    other_val = PanelSplits.by_date(panel, train_end, int(panel.dates[185]))
    with pytest.raises(ST.StackUnavailable, match="val months"):
        ST.StackedRuns(two, [splits, other_val], panel, device="cpu")
    monkeypatch.setenv("LFM_STACK_SHARDS", "2")
    with pytest.raises(NotImplementedError, match="item 10"):
        ST.StackedRuns(two, [splits] * 2, panel, device="cpu")
    monkeypatch.delenv("LFM_STACK_SHARDS")

    instants = []
    monkeypatch.setattr(telemetry, "instant",
                        lambda name, **kw: instants.append((name, kw)))
    before = telemetry.COUNTERS.snapshot().get("stack_degrades", 0)
    monkeypatch.setenv("LFM_BUCKETS", "1")
    with pytest.warns(UserWarning, match="LFM_BUCKETS"):
        out = ST.run_config_sweep(cfg, ST.parse_sweep_grid("lr=1e-3,3e-4"),
                                  panel=panel, stacked=True, device="cpu")
    assert out["stacked"] is None and len(out["runs"]) == 2
    assert telemetry.COUNTERS.snapshot()["stack_degrades"] == before + 1
    assert [n for n, _ in instants if n == "stack_degraded"] == \
        ["stack_degraded"]
    assert dict(instants)["stack_degraded"]["kind"] == "config"


def test_parse_sweep_grid_and_member_step_sizes():
    """The grid is the cartesian product in the JAX order; bad specs
    raise. The member optimizer's step size of member s at every count is
    its sequential ``AdamW.lr_at``; its decays are per member: eight
    updates equal each member's own AdamW (rtol 1e-6, atol 1e-7)."""
    assert ST.parse_sweep_grid(GRID) == [
        {"lr": 1e-3, "weight_decay": 1e-4}, {"lr": 1e-3, "weight_decay": 0},
        {"lr": 3e-4, "weight_decay": 1e-4}, {"lr": 3e-4, "weight_decay": 0}]
    assert ST.parse_sweep_grid(" lr = 1e-3 ; ") == [{"lr": 1e-3}]
    for bad, msg in (("dropout=0.1", "not sweepable"), ("lr", "not sweep"),
                     ("lr=1;lr=2", "duplicate"), ("lr=,", "no values"),
                     (";", "empty")):
        with pytest.raises(ValueError, match=msg):
            ST.parse_sweep_grid(bad)
    with pytest.raises(ValueError, match="unsupported sweep axes"):
        ST.run_config_sweep(_cfg(config, "runs"), [{"seed": 1}])
    o = config.OptimConfig(warmup_steps=5, lr=1e-3, weight_decay=1e-4)
    lrs, wds = [1e-3, 3e-4, 3e-2], [1e-4, 0.0, 1e-2]
    stacked = make_optimizer(o, 40, per_seed=True, lr=lrs, weight_decay=wds)
    for c in list(range(45)):
        row = stacked.lr_at(c)
        for s, lr in enumerate(lrs):
            assert row[s] == AdamW(lr, 0.0, 1.0, 5, 40).lr_at(c), (c, s)
    with pytest.raises(ValueError, match="per_seed"):
        AdamW(lrs, 0.0, 1.0, 5, 40)
    # Eight updates of a 3-member tree (gradients under the clip) against
    # each member's own AdamW on its slice; the decays collapsed to member
    # 0's (a control) move members 1 and 2 off their own.
    gen = torch.Generator().manual_seed(0)
    p0 = {"w": torch.randn(3, 4, 5, generator=gen),
          "b": torch.randn(3, 5, generator=gen)}
    gs = [{k: 1e-3 * torch.randn(v.shape, generator=gen)
           for k, v in p0.items()} for _ in range(8)]
    wds = [1e-1, 0.0, 1e-2]
    stacked = make_optimizer(o, 40, per_seed=True, lr=lrs, weight_decay=wds)

    def run(opt, params, grads):
        params = {k: v.clone() for k, v in params.items()}
        st = opt.init(params)
        for g in grads:
            opt.step(params, g, st)
        return params

    got = run(stacked, p0, gs)
    flat = run(make_optimizer(o, 40, per_seed=True, lr=lrs,
                              weight_decay=[wds[0]] * 3), p0, gs)
    for s, (lr, wd) in enumerate(zip(lrs, wds)):
        own = run(AdamW(lr, wd, 1.0, 5, 40), {k: v[s] for k, v in
                                              p0.items()},
                  [{k: v[s] for k, v in g.items()} for g in gs])
        for k in p0:
            torch.testing.assert_close(got[k][s], own[k], rtol=1e-6,
                                       atol=1e-7)
            assert s == 0 or not torch.allclose(flat[k][s], own[k],
                                                rtol=1e-6, atol=1e-7)


def _cli_config(tmp_path):
    c2 = config.get_preset("c2")
    cfg = dataclasses.replace(
        c2, name="tiny_sweep",
        data=dataclasses.replace(c2.data, window=12, firms_per_date=32),
        model=dataclasses.replace(c2.model, kwargs={"hidden": 8}),
        optim=dataclasses.replace(c2.optim, warmup_steps=3))
    path = tmp_path / "tiny.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_train_cli_sweep_grid(tmp_path, capsys):
    """``--sweep-grid`` trains the grid as one stack into
    ``<out>/<name>/sweep`` and prints the summary; its argument errors
    exit at parse time."""
    base = ["--config", _cli_config(tmp_path), "--device", "cpu",
            "--scale", "0.02", "--epochs", "1", "--out", str(tmp_path)]
    assert train_main(base + ["--sweep-grid", "lr=1e-3,3e-4"]) == 0
    summary = json.loads(capsys.readouterr().out)
    sweep = tmp_path / "tiny_sweep" / "sweep"
    assert summary["run_dir"] == str(sweep) and summary["n_configs"] == 2
    assert summary["stacked"]["enabled"] is True
    for name in ("sweep_summary.json", "config_000/config.json",
                 "config_001/ckpt/best", "config_001/metrics.jsonl"):
        assert (sweep / name).exists(), name
    for bad in (["--sweep-grid", "momentum=1"],
                ["--sweep-grid", "lr=1e-3", "--resume"],
                ["--sweep-grid", "lr=1e-3", "--walk-forward", "12",
                 "--wf-warm-start"]):
        with pytest.raises(SystemExit):
            train_main(base + bad)
