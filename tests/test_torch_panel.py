"""The port's numpy layers against the JAX package's, and the import guard.

``synthetic_panel``, the serving pools and months, the presets and the
bucket ladders are copies in the port; these tests hold them equal to the
JAX package's byte for byte. The import guard holds the port to its rule:
nothing of JAX and nothing of ``lfm_quant_tpu`` in
``lfm_quant_tpu_torch/`` or ``chip_smoke.py``.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from lfm_quant_tpu import buckets as jax_buckets
from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.windows import DateBatchSampler as JaxSampler
from lfm_quant_tpu.serve import buckets as jax_serve_buckets
from lfm_quant_tpu_torch import buckets, config
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.data.windows import DateBatchSampler, anchor_index
from lfm_quant_tpu_torch.serve import buckets as serve_buckets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANEL_FIELDS = ("features", "targets", "target_valid", "valid", "returns",
                "dates", "firm_ids", "ret_valid")


@pytest.mark.parametrize("kw", [
    dict(n_firms=30, n_months=90, n_features=5, seed=0),
    dict(n_firms=17, n_months=100, n_features=21, seed=3, horizon=6,
         start_yyyymm=198507),
    dict(n_firms=12, n_months=80, n_features=3, seed=9, het_noise=0.4),
])
def test_synthetic_panel_byte_equal(kw):
    a, b = synthetic_panel(**kw), jax_synthetic(**kw)
    for f in PANEL_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert list(a.feature_names) == list(b.feature_names)
    assert a.horizon == b.horizon


@pytest.mark.parametrize("window,min_valid", [(12, None), (60, None),
                                               (24, 5)])
def test_serving_pools_and_months_equal(window, min_valid):
    panel = synthetic_panel(n_firms=40, n_months=130, n_features=4, seed=2)
    ours = DateBatchSampler(panel, window, 1, 8, min_valid_months=min_valid,
                            min_cross_section=1, require_target=False)
    ref = JaxSampler(panel, window, 1, 8, seed=0, min_valid_months=min_valid,
                     min_cross_section=1, require_target=False)
    np.testing.assert_array_equal(ours.months_with_anchors(),
                                  ref.months_with_anchors())
    for t in range(panel.n_months):
        np.testing.assert_array_equal(ours.cross_section(t),
                                      ref.cross_section(t))
    for a, b in zip(ours.full_cross_sections(), ref.full_cross_sections(),
                    strict=True):
        for f in ("firm_idx", "time_idx", "weight"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # Serving eligibility drops the target conjunct: the live months serve.
    assert anchor_index(panel, window, min_valid, require_target=False)[
        :, -panel.horizon:].any()


def test_presets_equal():
    ours = {k: dataclasses.asdict(v) for k, v in config.PRESETS.items()}
    ref = {k: dataclasses.asdict(v) for k, v in jax_config.PRESETS.items()}
    assert ours == ref
    assert config.get_preset("c2").name == "c2_lstm_single"


def test_bucket_ladders_equal():
    for n in (1, 7, 8, 9, 1899, 4096, 4097):
        assert buckets.bucket_width(n) == jax_buckets.bucket_width(n)
    for r in (1, 3, 8, 9):
        assert buckets.rows_ladder(r) == jax_buckets.rows_ladder(r)
        for k in range(1, 12):
            assert serve_buckets.bucket_rows(k, r) == \
                jax_serve_buckets.bucket_rows(k, r)
    sizes = [3, 9, 100, 1899, 0]
    assert buckets.width_ladder(sizes) == jax_buckets.width_ladder(sizes)
    assert serve_buckets.max_rows_default() == \
        jax_serve_buckets.max_rows_default()


@pytest.mark.parametrize("specs", [("mom_12_1", "vol_6"),
                                   ("rev_1", "chg_ebit_ev_3", "mom_6_0")])
def test_derived_features_byte_equal(specs):
    """``data/features.py`` is a copy: below its docstring the JAX
    module's text, the ``Panel`` import aside, and the panels it derives
    byte-equal to the original's."""
    from lfm_quant_tpu.data.features import add_derived_features as jax_add
    from lfm_quant_tpu_torch.data.features import add_derived_features

    def body(path, pkg):
        text = open(os.path.join(ROOT, path)).read()
        return text[text.index("from __future__"):].replace(
            f"from {pkg}.data.panel import Panel", "from PANEL import Panel")

    assert body("lfm_quant_tpu_torch/data/features.py",
                "lfm_quant_tpu_torch") == body(
        "lfm_quant_tpu/data/features.py", "lfm_quant_tpu")
    kw = dict(n_firms=30, n_months=90, n_features=5, seed=4)
    a = add_derived_features(synthetic_panel(**kw), specs)
    b = jax_add(jax_synthetic(**kw), specs)
    for f in PANEL_FIELDS:
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert list(a.feature_names) == list(b.feature_names)


def _port_files():
    pkg = os.path.join(ROOT, "lfm_quant_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_no_jax_ast():
    """No ``import jax`` / ``lfm_quant_tpu`` (or flax, optax, ml_dtypes)
    anywhere in the port or chip_smoke.py."""
    banned = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "lfm_quant_tpu")
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert len(_port_files()) > 20
    # The seed ensemble's module (and its copied run-dir marker), the
    # parallel modules (the mesh, the ring, the launcher) and the MLP,
    # transformer, LRU and factorized recurrences are scanned.
    for rel in (("train", "ensemble.py"), ("parallel", "mesh.py"),
                ("parallel", "ring.py"), ("parallel", "launch.py"),
                ("utils", "distributed.py"), ("models", "mlp.py"),
                ("models", "transformer.py"), ("models", "lru.py"),
                ("models", "rnn.py"), ("train", "stacked.py"),
                ("train", "foldstack.py"), ("data", "features.py"),
                ("data", "compustat.py"), ("utils", "debug.py")):
        assert os.path.join(ROOT, "lfm_quant_tpu_torch", *rel) in \
            _port_files()
    assert not bad, bad


def test_port_runs_without_jax_in_sys_modules():
    """Import the whole package and serve c2 and c4 on the CPU in a fresh
    process: neither jax nor lfm_quant_tpu may be loaded, nor pandas (the
    card's machine has none: only the pandas engine imports it)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import lfm_quant_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from lfm_quant_tpu_torch.serve.__main__ import main\n"
        "main(['--preset', 'c2', '--n-firms', '16', '--n-months', '80',\n"
        "      '--requests', '4', '--threads', '2', '--device', 'cpu'])\n"
        "main(['--preset', 'c4', '--n-firms', '16', '--n-months', '80',\n"
        "      '--requests', '2', '--threads', '1', '--device', 'cpu'])\n"
        "for m in ('train.ensemble', 'parallel.mesh', 'parallel.ring',\n"
        "          'parallel.launch', 'utils.distributed', 'models.mlp',\n"
        "          'models.transformer', 'models.lru', 'models.rnn',\n"
        "          'train.stacked', 'train.foldstack', 'data.features',\n"
        "          'data.compustat', 'utils.debug'):\n"
        "    assert 'lfm_quant_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'lfm_quant_tpu', 'pandas')]\n"
        "assert not bad, bad\n"
        "print('IMPORT_GUARD_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORT_GUARD_OK" in r.stdout
