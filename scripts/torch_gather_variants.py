#!/usr/bin/env python3
"""Where the time of the window-gather kernel goes, on the card.

    python3 scripts/torch_gather_variants.py [--variants a,b,a]
                                             [--parent FILE] [--out FILE]

Builds variants of ``lfm_quant_tpu_torch/csrc/window_gather.cu``, each
made from the committed source by named text substitutions (``tma``: the
span read by one bulk copy, not the lanes' 16-byte loads), into separate
shared libraries (one ``nvcc`` each, all started together); ``--parent``
adds the variant ``parent``, built from another version of the source (for
example an earlier commit's, unpacked with ``git archive``). Times every
variant in the order given (a name may repeat, so ``parent,base,base,
parent`` compares two sources in turns) with ``chip_smoke.py device_ms``
(launches queued behind a device sleep, so the host's time is out) at the
main paths' shapes, bf16: the widest serving dispatches of the c2 and c3
panels (8 x 2048 and 8 x 4096 windows of W 60, F 20, as the batcher
builds them) and a synthetic fold on the c5 panel (512 date rows x 256
firms, seeded random dates and distinct firms: the shape of c5's seed
fold, not its index batch, so its bound differs from chip_smoke.py's).
Every variant but the ``diag_*`` ones is held bitwise to the plain
gather; ``diag_*`` variants remove a part of the work to show what it
costs. Prints one JSON line per measurement and writes them to
``--out`` (default ``build/gather_variants/gather.jsonl``). Needs a CUDA
card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "lfm_quant_tpu_torch", "csrc", "window_gather.cu")
BUILD = os.path.join(ROOT, "build", "gather_variants")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]

# The span read as one bulk copy (cp.async.bulk, the TMA's 1-D form) into
# the warp's buffer, completing on an mbarrier kept in 16 more bytes at the
# end of the warp's shared memory, instead of by the lanes' 16-byte loads.
_TMA = [
    ("    for (int c = lane; c < chunks; c += 32)\n"
     "      reinterpret_cast<uint4*>(buf)[c] = __ldg(src + c);\n"
     "    __syncwarp();\n",
     "    const unsigned bar = static_cast<unsigned>(\n"
     "        __cvta_generic_to_shared(smem + (warp + 1) * warp_bytes - 16));\n"
     "    if (lane == 0) {\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\"\n"
     "                   ::\"r\"(bar) : \"memory\");\n"
     "      asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
     "      asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");\n"
     "      asm volatile(\n"
     "          \"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\"\n"
     "          ::\"r\"(bar), \"r\"(chunks * 16) : \"memory\");\n"
     "      asm volatile(\n"
     "          \"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx\"\n"
     "          \"::bytes [%0], [%1], %2, [%3];\"\n"
     "          ::\"r\"(static_cast<unsigned>(__cvta_generic_to_shared(buf))),\n"
     "          \"l\"(src), \"r\"(chunks * 16), \"r\"(bar) : \"memory\");\n"
     "    }\n"
     "    __syncwarp();\n"
     "    asm volatile(\n"
     "        \"{\\n .reg .pred p;\\n WAIT_%=:\\n\"\n"
     "        \" mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\\n\"\n"
     "        \" @!p bra WAIT_%=;\\n}\" ::\"r\"(bar) : \"memory\");\n"),
    ("                                ~15LL);\n",
     "                                ~15LL) + 16;\n"),
]
# name → its text substitutions.
VARIANTS = {
    "base": [],
    "tma": _TMA,
    # Diagnostics: every window through the narrow stores; the span copy
    # without its output vectors (the reads, the flags and m alone).
    "diag_narrow": [("  if (span && first >= 0 && t < Tn",
                     "  if (false && span && first >= 0 && t < Tn")],
    "diag_no_vectors": [("    for (int v = lane; v < n / V; v += 32) {",
                         "    for (int v = lane; v < 0; v += 32) {")],
}


def variant_source(name: str, parent: str | None) -> str:
    if name == "parent":
        return open(parent).read()
    src = open(SRC).read()
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            if old not in src:
                raise SystemExit(f"variant {part}: pattern not in the "
                                 f"source:\n{old}")
            src = src.replace(old, new)
    return src


def build(names, parent):
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name in names:
        cu = os.path.join(BUILD, f"gather-{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name, parent))
        procs[name] = subprocess.Popen(
            [nvcc, *FLAGS, cu, "-o", os.path.join(BUILD, f"gather-{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(BUILD, f"gather-{name}.so"))
        lib.lfm_window_gather.argtypes = [ci] + [vp] * 5 + [ci] * 7 + [vp]
        lib.lfm_window_gather.restype = ci
        libs[name] = lib
    return libs


def shapes(torch, gen):
    """(where, xm, firm_idx, time_idx) at the main paths' shapes: the
    widest serving dispatches of the c2 and c3 panels (``chip_smoke.py
    widest_dispatch``: 8 months, pad columns repeating a pool's last firm)
    and a synthetic fold of seeded random dates and distinct firms on the
    c5 panel (512 date rows x 256 firms, the shape of c5's seed fold)."""
    import chip_smoke
    from lfm_quant_tpu_torch.config import compute_dtype, get_preset
    from lfm_quant_tpu_torch.data.windows import device_panel
    from lfm_quant_tpu_torch.train.loop import resolve_panel

    out = []
    for name in ("c2", "c3", "c5"):
        cfg = get_preset(name)
        panel = resolve_panel(cfg.data)
        xm = device_panel(panel, "cuda", compute_dtype(cfg))["xm"]
        N, T, _ = xm.shape
        if name == "c5":
            W = cfg.data.window
            ti = torch.randint(W - 1, T, (512,), generator=gen,
                               dtype=torch.int32)
            fi = torch.stack([torch.randperm(N, generator=gen)[:256]
                              for _ in range(512)]).to(torch.int32)
            where = "synthetic fold on the c5 panel"
        else:
            fi, ti = (torch.from_numpy(a) for a in chip_smoke.widest_dispatch(
                panel, cfg.data, 8))
            where = f"{name} widest serving dispatch"
        out.append((where, xm, fi.cuda(), ti.cuda(), cfg.data.window,
                    panel.n_features + 1))
        del panel
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma-separated, in timing order; default: every "
                         "variant (and parent, with --parent)")
    ap.add_argument("--parent", default=None,
                    help="another version of window_gather.cu (variant "
                         "'parent')")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed

    order = (args.variants or ",".join(
        list(VARIANTS) + (["parent"] if args.parent else []))).split(",")
    if "parent" in order and not args.parent:
        raise SystemExit("variant parent needs --parent FILE")
    names = list(dict.fromkeys(order))
    out_path = args.out or os.path.join(BUILD, "gather.jsonl")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build(names, args.parent)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator().manual_seed(0)
    cases = shapes(torch, gen)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    stream = torch.cuda.current_stream().cuda_stream
    with open(out_path, "w") as out:
        for where, xm, fi, ti, W, fp in cases:
            N, T, Fp = xm.shape
            D, Bf = fi.shape
            want_x, want_m = gather_windows_packed(xm, fi, ti, W, fp=fp)
            x = torch.empty_like(want_x)
            m = torch.empty_like(want_m)
            bound = chip_smoke.gather_bound(fi.cpu().numpy(),
                                            ti.cpu().numpy(), W, fp, T,
                                            xm.element_size())
            for name in order:
                lib = libs[name]

                def run():
                    err = lib.lfm_window_gather(
                        0 if xm.dtype == torch.float32 else 1, xm.data_ptr(),
                        fi.data_ptr(), ti.data_ptr(),
                        x.data_ptr(), m.data_ptr(), N, T, Fp, fp, D, Bf, W,
                        stream)
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")

                x.zero_()
                run()
                torch.cuda.synchronize()
                exact = bool(torch.equal(x.view(torch.uint8),
                                         want_x.view(torch.uint8))
                             and torch.equal(m, want_m))
                if not name.startswith("diag_") and not exact:
                    raise SystemExit(f"{name} at the {where}: differs from "
                                     f"the plain gather")
                rec = dict(variant=name, at=where, shape=[D, Bf, W, fp - 1],
                           ms=chip_smoke.device_ms(run, launches=20),
                           bound_ms=bound, exact=exact, card=card)
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
