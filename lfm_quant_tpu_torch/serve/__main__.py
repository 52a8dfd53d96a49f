"""Serve a preset's model and drive a closed-loop request load.

    python -m lfm_quant_tpu_torch.serve --preset c2 --requests 64 --threads 4
    python -m lfm_quant_tpu_torch.serve --preset c4   # or lru, c1, ...
    python -m lfm_quant_tpu_torch.serve --preset c2 --refresh --run-dir DIR
    python -m lfm_quant_tpu_torch.serve --preset c2 --http 8080
    python -m lfm_quant_tpu_torch.serve --preset c2 --persist STORE
    python -m lfm_quant_tpu_torch.serve --preset c2 --persist STORE --restore
    python -m lfm_quant_tpu_torch.serve --preset c2 --persist STORE --fleet 2

builds the preset's universe from ``synthetic_panel`` (its seed and
sizes), with the port's seeded init or ``--params file.npz`` holding a
converted Flax tree (``/``-joined keys, as ``weights.flatten_params``
writes them), warms every request-shape bucket, has ``--threads``
clients send ``--requests`` month queries in all, and prints the
service's stats as one JSON line. ``--refresh`` refreshes the universe
once (one epoch from the served params, on the preset's default splits)
while the clients send; ``--run-dir`` attaches telemetry (spans,
manifest, trace, the final ``metrics.prom`` scrape, or ``fleet.prom``
in fleet mode, incident bundles: ``python scripts/trace_report.py DIR``
rolls it up); ``--http PORT`` then serves the front door
(serve/http.py) on 127.0.0.1 until interrupted. Runs on the card;
``--device cpu`` serves through the kernels' plain versions.
``--n-firms`` and ``--n-months`` cut the panel's scale (never the
model's widths).

Durable state (serve/persist.py): ``--persist DIR`` (or
``LFM_ZOO_PERSIST``) commits every published generation to a store;
``--restore`` stands the service up from it instead, every universe
verified (params checksum, the probe month bitwise equal to the
publish-time probe; a snapshot that fails is quarantined loudly and its
universe rebuilt), and prints the restore's wall time and the first
response's latency after it. Fleet mode (serve/fleet.py): ``--fleet N``
(or ``LFM_FLEET``) publishes to the store, starts N member subprocesses
that each restore from it, admits them through the join gate and serves
through the failover router: one member's death is a reroute.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
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


def start_fleet(service, n: int, run_dir: Optional[str],
                device: Optional[str]):
    """Fleet mode: the parent's service has committed every universe to
    its store; it stops serving (its zoo dropped, the card's memory
    freed), N members start from the store, each is admitted through the
    join gate, and a router over them becomes the front door. Returns
    ``(router, member processes, temp dir or None)``; the caller stops
    the processes."""
    import tempfile

    from lfm_quant_tpu_torch.serve import fleet

    store = service.store
    service.close()
    for u in service.zoo.universes():
        service.zoo.drop(u)
    if service.device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    tmp = None
    if run_dir:
        fleet_dir = os.path.join(run_dir, "fleet")
        os.makedirs(fleet_dir, exist_ok=True)
    else:
        fleet_dir = tmp = tempfile.mkdtemp(prefix="lfm_fleet_")
    procs, specs = [], []
    try:
        for k in range(n):
            rf = os.path.join(fleet_dir, f"ready_m{k}.json")
            # Tracked the instant it exists: a later failure must still
            # stop every member.
            procs.append(fleet.spawn_member(store.root, ready_file=rf,
                                            device=device))
            specs.append((procs[-1], rf))
        coord = fleet.FleetCoordinator(store=store)
        for k, (proc, rf) in enumerate(specs):
            info = fleet.wait_member_ready(proc, rf)
            rep = coord.add_member(fleet.HttpMember(
                f"m{k}", f"http://127.0.0.1:{info['port']}",
                pid=info.get("pid")))
            print(f"[serve] fleet member m{k}: pid {info['pid']} port "
                  f"{info['port']}, restore kernel builds "
                  f"{rep.get('restore_compiles')}", flush=True)
    except BaseException:
        stop_members(procs)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    return fleet.FleetRouter(coord), procs, tmp


def stop_members(procs) -> None:
    """Terminate member processes, killing any that outlive 10 s."""
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:  # noqa: BLE001 — last resort
            p.kill()
            p.wait()


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
    ap.add_argument("--persist", default=None, metavar="DIR",
                    help="durable zoo store directory: every published "
                         "generation is committed there (falls back to "
                         "LFM_ZOO_PERSIST)")
    ap.add_argument("--restore", action="store_true",
                    help="stand the service up from the durable store "
                         "instead of building the universe: verified "
                         "snapshots, re-stamped drift references (a "
                         "universe that fails verification is rebuilt)")
    ap.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="fleet mode (default LFM_FLEET; unset/0 = one "
                         "process): publish to the durable store, start N "
                         "member subprocesses that each restore from it, "
                         "and serve through the failover router (needs "
                         "--persist or LFM_ZOO_PERSIST)")
    args = ap.parse_args(argv)
    store_set = bool(args.persist) or os.environ.get(
        "LFM_ZOO_PERSIST", "") not in ("", "0")
    if args.restore and not store_set:
        ap.error("--restore needs --persist DIR (or LFM_ZOO_PERSIST)")
    fleet_n = args.fleet
    if fleet_n is None:
        from lfm_quant_tpu_torch.serve.fleet import fleet_members_default

        fleet_n = fleet_members_default()
    if fleet_n and not store_set:
        ap.error("--fleet needs --persist DIR (or LFM_ZOO_PERSIST) — "
                 "members bootstrap from the durable store")
    if fleet_n and args.refresh:
        ap.error("--refresh is not supported with --fleet: the refresh "
                 "drives the parent service's zoo, which stops serving "
                 "once the members take over (fleet publishes propagate "
                 "through the store's fence)")
    if fleet_n:
        # The run manifest's `fleet` probe records the mode that ran.
        os.environ["LFM_FLEET"] = str(fleet_n)

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
    with telemetry.run_scope(args.run_dir, config=cfg,
                             extra={"entry": "serve"}), \
            ScoringService(device=args.device,
                           persist_dir=args.persist) as service:
        restored, restore_s, first_ms = [], None, None
        if args.restore:
            t0 = time.perf_counter()
            restored = service.restore()
            restore_s = time.perf_counter() - t0
            for info in restored:
                print(f"[serve] restored {info['universe']}: gen "
                      f"{info['generation']}, probe {info['probe']}",
                      flush=True)
            print(f"[serve] restore: {len(restored)} universe(s) in "
                  f"{restore_s:.3f} s, {service.last_restore_compiles} "
                  f"kernel builds, {service.last_restore_panel_h2d} "
                  "panel uploads", flush=True)
            if restored:
                # Time to the first response after the restore.
                u = restored[0]["universe"]
                months = service.serveable_months(u)
                t0 = time.perf_counter()
                service.score(u, months[len(months) // 2])
                first_ms = (time.perf_counter() - t0) * 1e3
        warm_s = None
        if cfg.name not in {info["universe"] for info in restored}:
            # A cold start, or a universe whose snapshots all failed
            # verification: build it (a retrain, never a missing one).
            panel = resolve_panel(cfg.data)
            t0 = time.perf_counter()
            service.register(cfg.name, cfg, panel, params)
            warm_s = time.perf_counter() - t0
        front, router, procs, fleet_tmp = service, None, [], None
        try:
            if fleet_n:
                router, procs, fleet_tmp = start_fleet(
                    service, fleet_n, args.run_dir, args.device)
                front = router
            front.reset_stats()
            _build.reset_launch_counts()
            refreshed = None
            if args.refresh:
                failed: List[BaseException] = []

                def load() -> None:
                    try:
                        drive_load(service, cfg.name, args.requests,
                                   args.threads)
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        failed.append(e)

                clients = threading.Thread(target=load)
                clients.start()
                refreshed = service.refresh(
                    cfg.name, splits_for(cfg, service.zoo.current(
                        cfg.name).panel), epochs=1).generation
                clients.join()
                if failed:
                    raise failed[0]
            else:
                drive_load(front, cfg.name, args.requests, args.threads)
            stats = front.stats()
            if args.run_dir:
                name = "fleet.prom" if router is not None else "metrics.prom"
                with open(os.path.join(args.run_dir, name), "w") as fh:
                    fh.write(front.metrics_text())
            stats.update(preset=cfg.name, warmup_s=warm_s,
                         refreshed_generation=refreshed,
                         kernel_launches=_build.launch_counts())
            if args.restore:
                stats.update(
                    restored=restored, restore_s=restore_s,
                    first_response_ms=first_ms,
                    restore_compiles=service.last_restore_compiles,
                    restore_panel_h2d=service.last_restore_panel_h2d)
            if service.device.type == "cuda":
                import torch

                stats["device_name"] = torch.cuda.get_device_name(
                    service.device)
            print(json.dumps(stats, default=str), flush=True)
            if args.http:
                run_http(front, args.http)
        finally:
            if router is not None:
                router.close()
            stop_members(procs)
            if fleet_tmp is not None:
                shutil.rmtree(fleet_tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
