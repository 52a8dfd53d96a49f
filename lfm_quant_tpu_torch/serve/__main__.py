"""Serve a preset's model and drive a closed-loop request load.

    python -m lfm_quant_tpu_torch.serve --preset c2 --requests 64 --threads 4
    python -m lfm_quant_tpu_torch.serve --preset c4   # or lru, c1, ...
    python -m lfm_quant_tpu_torch.serve --preset c2 --refresh --run-dir DIR
    python -m lfm_quant_tpu_torch.serve --preset c2 --http 8080

builds the preset's universe from ``synthetic_panel`` (its seed and
sizes), with the port's seeded init or ``--params file.npz`` holding a
converted Flax tree (``/``-joined keys, as ``weights.flatten_params``
writes them), warms every request-shape bucket, has ``--threads``
clients send ``--requests`` month queries in all, and prints the
service's stats as one JSON line. ``--refresh`` refreshes the universe
once (one epoch from the served params, on the preset's default splits)
while the clients send; ``--run-dir`` attaches telemetry (spans,
manifest, trace, the final ``metrics.prom`` scrape, incident bundles:
``python scripts/trace_report.py DIR`` rolls it up); ``--http PORT``
then serves the front door (serve/http.py) on 127.0.0.1 until
interrupted. Runs on the card; ``--device cpu`` serves through the
kernels' plain versions. ``--n-firms`` and ``--n-months`` cut the
panel's scale (never the model's widths).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
from typing import List, Optional

import numpy as np


def drive_load(service, universe: str, n_requests: int, n_threads: int,
               seed: int = 0) -> list:
    """Closed loop: each client thread scores months drawn from a seeded
    stream until the shared budget of ``n_requests`` is spent. Returns
    the responses."""
    months = service.serveable_months(universe)
    budget = iter(range(n_requests))
    lock = threading.Lock()
    responses = []
    errors: List[BaseException] = []

    def client(k: int) -> None:
        rng = np.random.default_rng([seed, k])
        while True:
            with lock:
                if next(budget, None) is None:
                    return
            month = months[int(rng.integers(len(months)))]
            try:
                resp = service.score(universe, month)
            except Exception as e:  # noqa: BLE001 — reported by the caller
                with lock:
                    errors.append(e)
                return
            with lock:
                responses.append(resp)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a load client did not finish within 600 s")
    return responses


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="c2",
                    help="model/data preset, any kind: c1 (MLP), c2, "
                         "c3 (LSTM, GRU), c4 (transformer), lru, lru64, lc, "
                         "or a full name")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests to drive in all (default 64)")
    ap.add_argument("--threads", type=int, default=4,
                    help="concurrent client threads (default 4)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--params", default=None, metavar="NPZ",
                    help="converted Flax param tree (default: seeded init)")
    ap.add_argument("--n-firms", type=int, default=None,
                    help="cut the panel to this many firms")
    ap.add_argument("--n-months", type=int, default=None,
                    help="cut the panel to this many months")
    ap.add_argument("--refresh", action="store_true",
                    help="refresh the universe once (one epoch from the "
                         "served params) while the clients send")
    ap.add_argument("--run-dir", default=None,
                    help="attach telemetry (spans/manifest/trace, the "
                         "final metrics.prom); roll up with "
                         "scripts/trace_report.py")
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="after the load, serve the HTTP front door on "
                         "127.0.0.1:PORT until interrupted")
    args = ap.parse_args(argv)

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.serve import ScoringService
    from lfm_quant_tpu_torch.serve.http import run_http
    from lfm_quant_tpu_torch.train.loop import resolve_panel, splits_for
    from lfm_quant_tpu_torch.utils import telemetry

    cfg = get_preset(args.preset)
    data = cfg.data
    if args.n_firms is not None:
        data = dataclasses.replace(data, n_firms=args.n_firms)
    if args.n_months is not None:
        data = dataclasses.replace(data, n_months=args.n_months)
    cfg = dataclasses.replace(cfg, data=data)
    params = None
    if args.params:
        with np.load(args.params) as z:
            params = {k: z[k] for k in z.files}
    panel = resolve_panel(cfg.data)

    with telemetry.run_scope(args.run_dir, config=cfg,
                             extra={"entry": "serve"}), \
            ScoringService(device=args.device) as service:
        t0 = time.perf_counter()
        service.register(cfg.name, cfg, panel, params)
        warm_s = time.perf_counter() - t0
        service.reset_stats()
        _build.reset_launch_counts()
        refreshed = None
        if args.refresh:
            failed: List[BaseException] = []

            def load() -> None:
                try:
                    drive_load(service, cfg.name, args.requests,
                               args.threads)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    failed.append(e)

            clients = threading.Thread(target=load)
            clients.start()
            refreshed = service.refresh(cfg.name, splits_for(cfg, panel),
                                        epochs=1).generation
            clients.join()
            if failed:
                raise failed[0]
        else:
            drive_load(service, cfg.name, args.requests, args.threads)
        stats = service.stats()
        if args.run_dir:
            with open(os.path.join(args.run_dir, "metrics.prom"), "w") as fh:
                fh.write(service.metrics_text())
        stats.update(preset=cfg.name, warmup_s=warm_s,
                     refreshed_generation=refreshed,
                     kernel_launches=_build.launch_counts())
        if service.device.type == "cuda":
            import torch

            stats["device_name"] = torch.cuda.get_device_name(service.device)
        print(json.dumps(stats, default=str), flush=True)
        if args.http:
            run_http(service, args.http)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
