"""The serving stack on the card (``cuda``-marked; skipped without one).

This file imports no jax: it runs on the card machine, beside
``chip_smoke.py``'s phase 18.

* ``dispatch_ms`` includes the device→host copy of the scores: a device
  sleep queued ahead of the dispatch's kernels shows up in it, since the
  host waits for the card at the copy.
* A transient fault on the card is retried onto the kernels: the same
  launches as a dispatch without the fault, bitwise-equal scores.
* An expired request launches no kernel.
* A month's served scores are the same bits alone and coalesced with
  other months at any row count and position (the probe's premise;
  cuBLAS's f32 product for the head's output layer was not, by the row
  count, before ``models/heads.py ordered_dense``).
* A restore from the durable store (``serve/persist.py``) in a fresh
  service: the probe ``bit_equal``, every score bitwise the scores served
  before, rows 3 and 5 launched, 0 kernel builds, one panel upload.
"""

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.config import get_preset
from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.serve import ScoringService
from lfm_quant_tpu_torch.serve.errors import DeadlineError, http_status
from lfm_quant_tpu_torch.train.loop import resolve_panel
from lfm_quant_tpu_torch.utils import faults

pytestmark = pytest.mark.cuda

KERNELS = ("rnn_fused_fwd_mma_lstm", "window_gather")
SLEEP_CYCLES = 20_000_000  # about 10 ms of device time


def _cut_c2():
    import dataclasses

    cfg = get_preset("c2")
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, n_firms=300, n_months=120))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (python3 chip_smoke.py runs "
                    "phases 18 and 23 there)")


@pytest.fixture
def service(card):
    """c2 (LSTM 128, bf16, window 60) over a cut panel, on the card."""
    cfg = _cut_c2()
    faults.configure("")
    svc = ScoringService(device="cuda", max_rows=4, max_wait_ms=0.0)
    svc.register("c2", cfg, resolve_panel(cfg.data))
    yield svc
    faults.configure("")
    svc.close()


def test_dispatch_ms_includes_the_scores_d2h(service):
    entry = service.zoo.current("c2")
    month = service.serveable_months("c2")[-1]
    service.score("c2", month)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    score_device = entry.score_device

    def slow(*a):
        torch.cuda._sleep(SLEEP_CYCLES)  # queued ahead of the kernels
        return score_device(*a)

    entry.score_device = slow
    r = service.score("c2", month)
    entry.score_device = score_device
    assert r.phases["dispatch_ms"] >= 0.9 * sleep_ms, (r.phases, sleep_ms)
    assert r.phases["dispatch_ms"] <= r.latency_ms + 1e-3


def test_transient_fault_retries_onto_the_kernels(service):
    month = service.serveable_months("c2")[-2]
    service.score("c2", month)
    _build.reset_launch_counts()
    ref = service.score("c2", month)
    want = _build.launch_counts()
    assert all(want[k] > 0 for k in KERNELS), want
    for spec in ("serve_dispatch:n=1", "zoo_lease:n=2"):
        faults.configure(spec)
        _build.reset_launch_counts()
        r = service.score("c2", month)
        assert _build.launch_counts() == want, spec
        np.testing.assert_array_equal(r.scores, ref.scores)
        assert r.phases["retries"] >= 1
    faults.configure("")
    assert service.stats()["retries"] == 3


def test_expired_request_launches_no_kernel(service):
    month = service.serveable_months("c2")[-3]
    service.score("c2", month)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    f = service.submit("c2", month, deadline_ms=1e-3)
    with pytest.raises(DeadlineError) as ei:
        f.result(timeout=30)
    assert http_status(ei.value) == 504
    assert not any(_build.launch_counts().values())
    assert service.stats()["deadline_drops"] == 1


def test_restore_on_the_card_is_bitwise(card, tmp_path):
    store = str(tmp_path / "store")
    cfg = _cut_c2()
    with ScoringService(device="cuda", max_rows=4, max_wait_ms=0.0,
                        persist_dir=store) as svc:
        svc.register("c2", cfg, resolve_panel(cfg.data))
        months = svc.serveable_months("c2")[::10]
        ref = {m: svc.score("c2", m).scores for m in months}
    with ScoringService(device="cuda", max_rows=4, max_wait_ms=0.0,
                        persist_dir=store) as svc:
        _build.reset_launch_counts()
        restored = svc.restore()
        got = {m: svc.score("c2", m).scores for m in months}
        launches = _build.launch_counts()
        assert [(r["generation"], r["probe"]) for r in restored] == \
            [(0, "bit_equal")]
        assert svc.last_restore_compiles == 0
        assert svc.last_restore_panel_h2d == 1
    assert all(launches[k] > 0 for k in KERNELS), launches
    for m in months:
        np.testing.assert_array_equal(got[m], ref[m])


def test_served_scores_are_batch_invariant_on_the_card(service):
    from lfm_quant_tpu_torch.serve.buckets import bucket_rows, bucket_width
    from lfm_quant_tpu_torch.serve.persist import score_single_month

    entry = service.zoo.current("c2")
    months = service.serveable_months("c2")
    by_width = {}
    for m in months:
        by_width.setdefault(
            bucket_width(entry.pool(entry.month_col(m)).size), []).append(m)
    for group in by_width.values():
        for m in group[:2]:
            alone = score_single_month(entry, m, 1)
            n = alone.size
            others = [o for o in group if o != m] or [m]
            for real in (2, 3, 5, 8):
                rows = bucket_rows(real, 8)
                batch = [m] + (others * 8)[:real - 1]
                pools = [(entry.month_col(o), entry.pool(entry.month_col(o)))
                         for o in batch]
                width = bucket_width(max(p.size for _, p in pools))
                fi = np.zeros((rows, width), np.int32)
                ti = np.zeros((rows,), np.int32)
                w = np.zeros((rows, width), np.float32)
                for i, (t, pool) in enumerate(pools):
                    fi[i, :pool.size], fi[i, pool.size:] = pool, pool[-1]
                    ti[i], w[i, :pool.size] = t, 1.0
                for i in range(real, rows):
                    fi[i], ti[i] = fi[0], ti[0]
                got = entry.score(fi, ti, w)
                np.testing.assert_array_equal(got[0, :n], alone)
