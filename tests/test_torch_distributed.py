"""The port's data parallelism against one process and against the JAX
package.

* ``utils/distributed.py maybe_initialize`` over a table of environments,
  held to the JAX function where both can run (none set → False; some set
  → ``ValueError`` naming the missing keys), and what it hands
  ``init_process_group`` when fully configured.
* ``parallel/mesh.py``: ``resolve_data_shards`` (the JAX rule), the month
  blocks of the sharded sweeps, ``shard_dates``.
* 4 gloo ranks (``parallel/launch.py run_ranks``, a ``file://``
  rendezvous under ``tmp_path``) run epoch 0 of the port ``Trainer``
  (GRU hidden 16, window 12, 8 dates of the full cross-section, f32, CPU)
  for ``rank_ic`` and ``mse``: every rank's per-step loss and grad_norm and
  its final params equal the one-process port's (rtol 1e-5, atol 1e-6:
  only the reduction order differs) and the one-device JAX trainer's
  (rtol 1e-4, atol 1e-5); each step's loss equals the JAX trainer's at
  ``n_data_shards=4`` on the virtual CPU devices from the same params.
  The JAX trainer's sharded gradients are 4 times the one-device ones
  (ROADMAP.md Queue C), so the port is held to the one-device gradients.
* 2 ranks: the month-sharded ``_eval_dispatch``, ``evaluate`` and
  ``predict`` equal the unsharded port (rtol 1e-5, atol 1e-6), and the
  bind errors of a 2-rank world.
* 2 ranks through the train entry point with early stopping: identical
  histories on both ranks, equal to one process; rank 1 writes nothing;
  a run killed after its first epoch and resumed ends as the unbroken run.

Every job has a time limit (``run_ranks`` kills what is left) and every
collective a 60 s one, so no test can hang the suite.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.utils.distributed import maybe_initialize as jax_init
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.parallel import mesh as M
from lfm_quant_tpu_torch.parallel.launch import run_ranks
from lfm_quant_tpu_torch.utils import distributed as D
from lfm_quant_tpu_torch.weights import flatten_params

import torch_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
PANEL = dict(n_firms=40, n_months=120, n_features=5, seed=0)
CUT = (84, 102)  # train_end, val_end (month indices)
JOB_S = 120      # each job's limit
# rank-IC is invariant to a shift of the forecast, so the output bias's
# gradient is zero up to rounding, and Adam scales that noise to lr-sized
# steps: its value is held to |move| <= lr x steps instead.
SHIFT_FREE = {"rank_ic": ("head/out/bias",), "mse": ()}


def _cfg(mod, loss, n_data_shards, scan_impl, **optim):
    return mod.RunConfig(
        name="dp",
        data=mod.DataConfig(n_firms=40, n_months=120, n_features=5,
                            window=12, dates_per_batch=8, firms_per_date=0),
        model=mod.ModelConfig(kind="gru", kwargs={"hidden": 16},
                              scan_impl=scan_impl),
        optim=mod.OptimConfig(**dict(dict(lr=3e-3, warmup_steps=2, epochs=1,
                                          loss=loss), **optim)),
        seed=5, n_data_shards=n_data_shards)


def _jax_splits():
    p = jax_synthetic(**PANEL)
    return JaxSplits.by_date(p, int(p.dates[CUT[0]]), int(p.dates[CUT[1]]))


def _ranks(n, fn, tmp_path, **payload):
    return run_ranks(n, f"torch_ranks:{fn}", payload, str(tmp_path / fn),
                     JOB_S, python_path=[HERE])


# ---------------------------------------------------------------------------
# initialization and the mesh
# ---------------------------------------------------------------------------

ENVS = {
    "none": {},
    "empty values": {"LFM_COORDINATOR": "", "LFM_PROCESS_ID": ""},
    "coordinator only": {"LFM_COORDINATOR": "h:1"},
    "no process id": {"LFM_COORDINATOR": "h:1", "LFM_NUM_PROCESSES": "2"},
    "no coordinator": {"LFM_NUM_PROCESSES": "2", "LFM_PROCESS_ID": "0"},
    "part of a launcher's": {"MASTER_ADDR": "localhost", "RANK": "0"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_maybe_initialize_matches_jax(name):
    env = ENVS[name]
    try:
        want = jax_init(env)
    except ValueError as e:
        want = e
    if isinstance(want, ValueError):
        with pytest.raises(ValueError) as got:
            D.maybe_initialize(env)
        assert str(got.value) == str(want)
        missing = [k for k in D.KEYS if not env.get(k)]
        assert all(k in str(got.value) for k in missing)
    else:
        assert want is False and D.maybe_initialize(env) is False
    assert not D.initialized()


@pytest.mark.parametrize("env,init", [
    ({"LFM_COORDINATOR": "host0:8476", "LFM_NUM_PROCESSES": "4",
      "LFM_PROCESS_ID": "3"},
     dict(init_method="tcp://host0:8476", world_size=4, rank=3)),
    ({"LFM_COORDINATOR": "file:///tmp/x", "LFM_NUM_PROCESSES": "2",
      "LFM_PROCESS_ID": "0"},
     dict(init_method="file:///tmp/x", world_size=2, rank=0)),
    ({"LFM_AUTO_DISTRIBUTED": "1"}, dict(init_method="env://")),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "WORLD_SIZE": "2",
      "RANK": "1"}, dict(init_method="env://")),
])
def test_maybe_initialize_configures_the_group(monkeypatch, env, init):
    calls = []
    monkeypatch.setattr(D.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    assert D.maybe_initialize(env, backend="gloo", timeout_s=42) is True
    (backend, kw), = calls
    assert backend == "gloo" and kw.pop("timeout").total_seconds() == 42
    assert kw == init
    assert D.default_backend() == "gloo"  # no card here
    assert (D.rank(), D.world_size(), D.is_main()) == (0, 1, True)
    D.barrier()  # no group: a no-op


def test_mesh_rules():
    for n, world in ((8, 1), (8, 4), (2, 4), (1, 8), (0, 3), (16, 16)):
        assert M.resolve_data_shards(n, world) == max(1, min(n, world))
    assert M.data_mesh(8) == M.DataMesh(1, 0)
    assert M.mesh_fingerprint(M.DataMesh()) == (("data",), (1,), None)
    x = np.arange(24).reshape(8, 3)
    t = torch.from_numpy(x)
    blocks = [M.shard_dates(t, M.DataMesh(4, r)) for r in range(4)]
    assert np.array_equal(np.concatenate([b.numpy() for b in blocks]), x)
    with pytest.raises(ValueError, match="divisible"):
        M.shard_dates(t[:6], M.DataMesh(4, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        raise M.axis_not_ported(M.FOLD_AXIS)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_month_blocks(n):
    """Equal blocks of whole chunks, real months first and in order: the
    ranks' real rows put together are the months 0..M-1; one rank is the
    single-device sweep's padding."""
    for M_ in (1, 2, 3, 5, 8, 9, 17, 33):
        for dpb in (1, 4, 8):
            blocks = [M.month_block(M_, dpb, M.DataMesh(n, r))
                      for r in range(n)]
            C = min(dpb, -(-M_ // n))
            assert len({len(rows) for rows, _ in blocks}) == 1
            assert len(blocks[0][0]) % C == 0
            real = np.concatenate([rows[:k].numpy() for rows, k in blocks])
            assert np.array_equal(real, np.arange(M_))
            if n == 1:
                rows, k = blocks[0]
                pad = (-M_) % min(dpb, M_)
                assert k == M_ and np.array_equal(
                    rows.numpy(), np.r_[np.arange(M_), np.arange(pad)])


# ---------------------------------------------------------------------------
# 4 ranks against one process and the JAX trainers
# ---------------------------------------------------------------------------


def _jax_steps(loss):
    """Epoch 0 of the one-device JAX trainer: init params, per-step loss
    and grad_norm, final params; and each step's loss from the JAX
    trainer at n_data_shards=4, fed the one-device state of that step."""
    splits = _jax_splits()
    t1 = JaxTrainer(_cfg(jax_config, loss, 1, "xla"), splits)
    t4 = JaxTrainer(_cfg(jax_config, loss, 4, "xla"), splits)
    assert t1.mesh is None and t4.mesh.shape["data"] == 4
    s = t1.init_state()
    init = jax.tree_util.tree_map(np.asarray, s.params)
    out = {"losses": [], "grad_norms": [], "sharded_losses": []}
    replicated = NamedSharding(t4.mesh, P())
    for b in t1.train_sampler.epoch(0):
        s4 = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, replicated), s)
        _, m4 = t4._jit_step(s4, t4.dev, *t4._batch_args(b, train=True))
        s, m1 = t1._jit_step(s, t1.dev, *t1._batch_args(b, train=True))
        out["losses"].append(float(m1["loss"]))
        out["grad_norms"].append(float(m1["grad_norm"]))
        out["sharded_losses"].append(float(m4["loss"]))
    out["params"] = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                          s.params))
    return init, out


@pytest.mark.parametrize("loss", ["rank_ic", "mse"])
def test_four_ranks_match_one_process_and_jax(tmp_path, loss):
    init, jx = _jax_steps(loss)
    cfg = _cfg(config, loss, 4, "pallas_fused")
    one = R.epoch_steps(cfg, PANEL, CUT, init)
    assert one["world"] == 1 and one["n_data"] == 1
    ranks = _ranks(4, "epoch_steps", tmp_path, cfg=cfg, panel_kw=PANEL,
                   cut=CUT, init=init)
    n_steps = len(jx["losses"])
    assert n_steps >= 4 and len(one["losses"]) == n_steps
    lr = cfg.optim.lr
    for r, got in enumerate(ranks):
        assert (got["rank"], got["world"], got["n_data"]) == (r, 4, 4)
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got[key], jx[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["losses"], jx["sharded_losses"],
                                   rtol=1e-4, atol=1e-5)
        for k, p in got["params"].items():
            if k in SHIFT_FREE[loss]:
                assert np.abs(p - flatten_params(init)[k]).max() <= \
                    lr * n_steps
                continue
            np.testing.assert_allclose(p, one["params"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(p, jx["params"][k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        assert got["eval"]["n_months"] == one["eval"]["n_months"]
        np.testing.assert_allclose(got["eval"]["ic"], one["eval"]["ic"],
                                   rtol=1e-5, atol=1e-6)
        if not SHIFT_FREE[loss]:
            np.testing.assert_allclose(got["eval"]["mse"],
                                       one["eval"]["mse"], rtol=1e-5)
    # Every rank took identical steps.
    for got in ranks[1:]:
        assert got["losses"] == ranks[0]["losses"]
        for k, p in got["params"].items():
            assert np.array_equal(p, ranks[0]["params"][k]), k


# ---------------------------------------------------------------------------
# 2 ranks: the month-sharded sweeps, the bind errors
# ---------------------------------------------------------------------------


def test_two_ranks_shard_the_sweeps(tmp_path):
    init = _jax_init()
    cfg = _cfg(config, "rank_ic", 2, "pallas_fused")
    one = R.sweeps(cfg, PANEL, CUT, init)
    ranks = _ranks(2, "sweeps", tmp_path, cfg=cfg, panel_kw=PANEL, cut=CUT,
                   init=init)
    assert one["errors"] == {}
    for got in ranks:
        np.testing.assert_allclose(got["ic"], one["ic"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["mse"], one["mse"], rtol=1e-5)
        assert got["eval"]["n_months"] == one["eval"]["n_months"]
        np.testing.assert_allclose(
            [got["eval"]["ic"], got["eval"]["mse"]],
            [one["eval"]["ic"], one["eval"]["mse"]], rtol=1e-5, atol=1e-6)
        for part in ("test", "short"):
            (fc, valid), (fc1, valid1) = got[part], one[part]
            assert valid.any() and np.array_equal(valid, valid1)
            np.testing.assert_allclose(fc, fc1, rtol=1e-5, atol=1e-6)
        err = got["errors"]
        assert "ValueError" in err["shards"] and "2 processes" in err[
            "shards"] and "resolves to 1" in err["shards"]
        assert "ValueError" in err["divisible"] and "divisible" in err[
            "divisible"]
        assert "ValueError" in err["seeds"] and "2 processes" in err[
            "seeds"] and "seed 1 x data 1 x seq 1" in err["seeds"]
    assert ranks[0]["short"][1].sum() > 0
    assert np.array_equal(ranks[0]["test"][0], ranks[1]["test"][0])


def _jax_init():
    t = JaxTrainer(_cfg(jax_config, "rank_ic", 1, "xla"), _jax_splits())
    return jax.tree_util.tree_map(np.asarray, t.init_state().params)


# ---------------------------------------------------------------------------
# 2 ranks through the train entry point: early stop, writes, resume
# ---------------------------------------------------------------------------


def _fit_json(tmp_path):
    cfg = _cfg(config, "mse", 2, "pallas_fused", lr=1e-2, epochs=6,
               early_stop_patience=1)
    path = tmp_path / "fit.json"
    path.write_text(cfg.to_json())
    return str(path)


def _numbers(history):
    """A history without its clock readings."""
    return [{k: v for k, v in rec.items()
             if k not in ("ts", "firm_months_per_sec")} for rec in history]


def _history(out):
    lines = (out / "dp" / "seed5" / "metrics.jsonl").read_text()
    return _numbers(json.loads(x) for x in lines.splitlines())


def test_two_rank_fit_early_stops_writes_once_and_resumes(tmp_path):
    argv = ["--config", _fit_json(tmp_path), "--device", "cpu"]
    one, whole, cut = (tmp_path / d for d in ("one", "whole", "cut"))
    want = R.train_cli(argv + ["--out", str(one)])["summary"]
    assert want["epochs_run"] < 6  # early stopping
    ranks = _ranks(2, "train_cli", tmp_path / "a",
                   argv=argv + ["--out", str(whole)])
    h0, h1 = (_numbers(r["summary"]["history"]) for r in ranks)
    assert h0 == h1 and len(h0) == want["epochs_run"]
    for a, b in zip(h0, want["history"], strict=True):
        for k in ("train_loss", "grad_norm", "val_ic", "val_mse"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert ranks[0]["summary"]["best_epoch"] == want["best_epoch"]
    assert ranks[0]["summary"]["mesh"] == (("data",), (2,), "gloo")
    assert ranks[1]["written"] == []
    assert any(p.endswith("metrics.jsonl") for p in ranks[0]["written"])
    assert any("ckpt" in p for p in ranks[0]["written"])

    crashed = _ranks(2, "train_cli", tmp_path / "b",
                     argv=argv + ["--out", str(cut)], crash_after_epoch=0)
    assert all(r.get("crashed") for r in crashed)
    resumed = _ranks(2, "train_cli", tmp_path / "c",
                     argv=argv + ["--out", str(cut), "--resume"])
    assert resumed[1]["written"] == []
    assert _numbers(resumed[0]["summary"]["history"]) == \
        _numbers(resumed[1]["summary"]["history"])
    assert resumed[0]["summary"]["epochs_run"] == want["epochs_run"]
    assert [r["epoch"] for r in _history(cut)] == list(
        range(want["epochs_run"]))
    for a, b in zip(_history(cut), _history(whole), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
