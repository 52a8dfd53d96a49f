"""Real-data loader: the port of ``lfm_quant_tpu/data/compustat.py``.

Compustat-style long-format files (``gvkey,yyyymm,<features...>,ret``,
one row per firm-month) → a :class:`Panel`: per-month winsorized and
z-scored features, the target feature ``horizon`` months ahead, forward
returns from the trailing ones, validity from row presence.
``load_compustat_csv(engine=...)``: "native" parses a ``.csv`` with the
C++ parser of ``native/panel_native.cpp`` (``csv_parse_buf``, bound by
``native/__init__.py``); "pandas" reads a CSV or parquet with pandas;
"auto" takes the native parser for a ``.csv`` when it builds, else
pandas. pandas is imported only by the pandas engine and
:func:`to_long_frame`: on a machine without pandas the CSV path runs
native and :func:`write_long_csv` writes the files.
Below the docstring the module is the original's but for those imports,
the engines' timing note (taken on the JAX package's host) and
:func:`write_long_csv` (``tests/test_torch_realpanel.py`` holds its
panels to the original's).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from lfm_quant_tpu_torch.data.panel import Panel

RESERVED = ("gvkey", "yyyymm", "ret")


def _pandas():
    """pandas, imported by the pandas engine and ``to_long_frame`` only:
    the native engine and the CSV writer run without it."""
    try:
        import pandas as pd
    except ImportError:
        raise RuntimeError(
            "this path needs pandas, which is not installed: read a .csv "
            "with engine='native' (or 'auto'), write one with "
            "write_long_csv") from None
    return pd


def _read_table(path: str):
    pd = _pandas()
    if path.endswith((".parquet", ".pq")):
        return pd.read_parquet(path)
    return pd.read_csv(path)


def _parse_pandas(path, feature_cols):
    """→ (gvkey[int32 R], yyyymm[int32 R], feats[f32 R×F], ret[f32 R]|None,
    feature_cols). NaN marks missing feature/return fields."""
    pd = _pandas()
    df = _read_table(path)
    missing = [c for c in ("gvkey", "yyyymm") if c not in df.columns]
    if missing:
        raise ValueError(f"input file lacks required columns {missing}")
    if feature_cols is None:
        feature_cols = [
            c for c in df.columns
            if c not in RESERVED and pd.api.types.is_numeric_dtype(df[c])
        ]
        ignored = [c for c in df.columns
                   if c not in RESERVED and c not in feature_cols]
        if ignored:
            import sys

            print(f"load_compustat_csv: ignoring non-numeric columns "
                  f"{ignored}", file=sys.stderr)
    else:
        absent = [c for c in feature_cols if c not in df.columns]
        if absent:
            raise ValueError(f"feature columns {absent} not in file")
    gvkey = df["gvkey"].to_numpy(dtype=np.int32)
    yyyymm = df["yyyymm"].to_numpy(dtype=np.int32)
    feats = (df[list(feature_cols)].to_numpy(dtype=np.float32)
             if feature_cols else
             np.zeros((len(df), 0), np.float32))
    ret = (df["ret"].to_numpy(dtype=np.float32)
           if "ret" in df.columns else None)
    return gvkey, yyyymm, feats, ret, list(feature_cols)


def _parse_native(path, feature_cols):
    """Native C++ CSV parse (lfm_quant_tpu_torch.native) — same contract as
    :func:`_parse_pandas`; returns None when the native library is
    unavailable so the caller can fall back."""
    from lfm_quant_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    import ctypes
    import csv as _csv
    import io

    # ONE disk read: the bytes are passed straight into the (non-mutating)
    # C parser; header/first-row sniffing reuses the same buffer. csv.reader
    # handles RFC-4180 quoting in the header, matching the C field scanner.
    with open(path, "rb") as fh:
        data = fh.read()
    head_bytes = data[:1 << 20]
    if len(data) > len(head_bytes):
        # The buffer cut the file mid-row: drop the trailing partial line
        # or the sniff would misread a truncated numeric ('1.25e-') as text.
        head_bytes = head_bytes[:head_bytes.rfind(b"\n") + 1]
    head = io.StringIO(head_bytes.decode("utf-8", "replace"))
    reader = _csv.reader(head)
    header = next(reader, [])
    cols = {c: i for i, c in enumerate(header)}
    missing = [c for c in ("gvkey", "yyyymm") if c not in cols]
    if missing:
        raise ValueError(f"input file lacks required columns {missing}")
    if feature_cols is None:
        # Type-sniff candidate feature columns over MANY rows (the whole
        # 1 MB head buffer, up to 4096 rows) — a single-row sniff
        # misclassifies sparse text columns whose first value is blank,
        # and silently NaNs text in mostly-numeric columns. A column is
        # numeric iff no scanned non-empty value fails float(); all-empty
        # columns stay included (pandas parses those as float NaN columns,
        # so inclusion is the parity behavior).
        saw_text = [False] * len(header)
        n_scanned = 0
        for row in reader:
            if not row:
                continue
            for i in range(min(len(row), len(header))):
                v = row[i].strip().strip('"')  # parser strips quotes too
                if not v:
                    continue
                try:
                    float(v)
                except ValueError:
                    saw_text[i] = True
            n_scanned += 1
            if n_scanned >= 4096:
                break

        feature_cols = [c for c in header
                        if c not in RESERVED and not saw_text[cols[c]]]
        ignored = [c for c in header
                   if c not in RESERVED and c not in feature_cols]
        if ignored:
            import sys

            print(f"load_compustat_csv: ignoring non-numeric columns "
                  f"{ignored}", file=sys.stderr)
    else:
        absent = [c for c in feature_cols if c not in cols]
        if absent:
            raise ValueError(f"feature columns {absent} not in file")

    n_rows = max(data.count(b"\n"), 1)  # capacity bound (header + blanks)
    F = len(feature_cols)
    gvkey = np.empty(n_rows, np.int32)
    yyyymm = np.empty(n_rows, np.int32)
    feats = np.empty((n_rows, max(F, 1)), np.float32)
    has_ret = "ret" in cols
    ret = np.empty(n_rows, np.float32) if has_ret else None
    feat_idx = np.asarray([cols[c] for c in feature_cols], np.int32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty)) if a is not None else None

    got = lib.csv_parse_buf(
        data, len(data), len(header), cols["gvkey"], cols["yyyymm"],
        cols.get("ret", -1), ptr(feat_idx, ctypes.c_int32), F, n_rows,
        ptr(gvkey, ctypes.c_int32), ptr(yyyymm, ctypes.c_int32),
        ptr(feats, ctypes.c_float), ptr(ret, ctypes.c_float))
    if got < 0:
        raise ValueError(f"{path}: malformed data row {-got} "
                         "(bad gvkey/yyyymm field)")
    n = int(got)  # blank lines make got < the newline-count estimate
    return (gvkey[:n], yyyymm[:n], feats[:n, :F], ret[:n] if has_ret else
            None, list(feature_cols))


def _month_grid(months: np.ndarray) -> np.ndarray:
    """Full consecutive YYYYMM range spanning the observed months."""
    lo, hi = int(months.min()), int(months.max())
    y, m = lo // 100, lo % 100
    out = []
    while y * 100 + m <= hi:
        out.append(y * 100 + m)
        m += 1
        if m > 12:
            m, y = 1, y + 1
    return np.asarray(out, dtype=np.int32)


def load_compustat_csv(
    path: str,
    feature_cols: Optional[Sequence[str]] = None,
    target_col: Optional[str] = None,
    horizon: int = 12,
    winsor: Tuple[float, float] = (0.01, 0.99),
    min_cross_section: int = 5,
    engine: str = "auto",
) -> Panel:
    """Load a long-format fundamentals file into a :class:`Panel`.

    Args:
      path: CSV or parquet file in the documented schema.
      feature_cols: columns to use as features (default: every non-reserved
        numeric column, in file order).
      target_col: which (standardized) feature the model forecasts
        ``horizon`` months ahead (default: the first feature).
      horizon: forecast lookahead in months.
      winsor: per-month winsorization quantiles (lo, hi); None disables.
      min_cross_section: months with fewer valid firms than this are left
        unstandardized-invalid (degenerate z-scores are worse than no data).
      engine: "auto" (native C++ parser for .csv when built, else pandas),
        "native", or "pandas". On well-formed numeric files (including
        RFC-4180 quoted fields) the engines produce identical panels. One
        divergence remains: with ``feature_cols=None`` the native engine
        type-sniffs from the first ~4096 rows (1 MB), pandas from whole
        columns — pass explicit ``feature_cols`` for files whose first
        text value appears later than that.
    """
    if engine not in ("auto", "native", "pandas"):
        raise ValueError(f"engine must be auto|native|pandas, got {engine!r}")
    parsed = None
    if engine in ("auto", "native") and path.endswith(".csv"):
        parsed = _parse_native(path, feature_cols)
        if parsed is None and engine == "native":
            raise RuntimeError(
                "engine='native' but the native library is unavailable "
                "(no toolchain, or the build failed — see stderr)")
    elif engine == "native":
        raise ValueError("engine='native' supports only .csv inputs")
    if parsed is None:
        parsed = _parse_pandas(path, feature_cols)
    gvkey, yyyymm, row_feats, row_rets, feature_cols = parsed

    if not feature_cols:
        raise ValueError("no feature columns found")
    if target_col is None:
        target_col = feature_cols[0]
    if target_col not in feature_cols:
        raise ValueError(
            f"target_col {target_col!r} must be one of the features "
            f"{list(feature_cols)}")

    key = gvkey.astype(np.int64) * 1_000_000 + yyyymm
    uniq, counts = np.unique(key, return_counts=True)
    if (counts > 1).any():
        bad = uniq[counts > 1][:3]
        raise ValueError(
            "duplicate (gvkey, yyyymm) rows, e.g. "
            f"{[(int(k // 1_000_000), int(k % 1_000_000)) for k in bad]}")

    dates = _month_grid(yyyymm)
    firms = np.unique(gvkey).astype(np.int32)
    n, t, f = len(firms), len(dates), len(feature_cols)
    rows = np.searchsorted(firms, gvkey)
    cols = np.searchsorted(dates, yyyymm)
    # searchsorted maps an off-grid month (e.g. 199913) to its insertion
    # point — validate exact grid membership or rows would silently land
    # in the wrong month's cell.
    bad = dates[np.minimum(cols, t - 1)] != yyyymm
    if bad.any():
        idx = np.nonzero(bad)[0][:3]
        raise ValueError(
            "rows with invalid yyyymm (not a real calendar month): "
            f"{[(int(gvkey[i]), int(yyyymm[i])) for i in idx]}")

    feats = np.full((n, t, f), np.nan, dtype=np.float32)
    rets = np.full((n, t), np.nan, dtype=np.float32)
    feats[rows, cols] = row_feats
    has_ret = row_rets is not None
    if has_ret:
        rets[rows, cols] = row_rets

    valid = ~np.isnan(feats).any(axis=2)

    # Per-month winsorize + z-score over the valid cross-section — the
    # shared recipe (data/features.py winsorize_zscore) so derived
    # columns standardize identically.
    from lfm_quant_tpu_torch.data.features import winsorize_zscore

    for j in range(t):
        rowsel = valid[:, j]
        if rowsel.sum() < min_cross_section:
            valid[:, j] = False
            continue
        feats[rowsel, j, :] = winsorize_zscore(feats[rowsel, j, :], winsor)

    feats = np.where(valid[..., None], feats, 0.0).astype(np.float32)

    # Targets: standardized target feature at t+horizon.
    ti = list(feature_cols).index(target_col)
    targets = np.zeros((n, t), dtype=np.float32)
    target_valid = np.zeros((n, t), dtype=bool)
    if horizon < t:
        future = feats[:, horizon:, ti]
        fvalid = valid[:, horizon:]
        targets[:, :-horizon] = np.where(fvalid, future, 0.0)
        target_valid[:, :-horizon] = valid[:, :-horizon] & fvalid

    # Returns: vendor files carry trailing returns (t-1 → t); the backtest
    # wants the forward return earned from holding over [t, t+1]. A missing
    # t+1 observation (delisting, gap) makes the forward return UNOBSERVED
    # — flagged in ret_valid, never fabricated as 0% (delisting bias).
    fwd = np.zeros((n, t), dtype=np.float32)
    ret_valid = np.zeros((n, t), dtype=bool)
    if not has_ret:
        # No return data at all: every cell unobserved; backtests on this
        # panel are meaningless and will raise on an empty universe.
        pass
    elif t > 1:
        nxt = rets[:, 1:]
        obs = ~np.isnan(nxt)
        fwd[:, :-1] = np.where(obs, nxt, 0.0)
        ret_valid[:, :-1] = obs & valid[:, :-1]
    fwd = np.where(valid, fwd, 0.0).astype(np.float32)

    panel = Panel(
        features=feats,
        targets=targets,
        target_valid=target_valid,
        valid=valid,
        returns=fwd,
        dates=dates,
        firm_ids=firms,
        feature_names=list(feature_cols),
        horizon=horizon,
        ret_valid=ret_valid,
    )
    panel.validate()
    return panel


def to_long_frame(panel: Panel):
    """Inverse helper: Panel → long-format DataFrame (fixtures, exports).
    Emits one row per valid (firm, month); ``ret`` is re-expressed in the
    trailing convention (row t carries the return from t-1 to t)."""
    pd = _pandas()
    n, t = panel.valid.shape
    fi, ti = np.nonzero(panel.valid)
    data = {
        "gvkey": panel.firm_ids[fi],
        "yyyymm": panel.dates[ti],
    }
    for k, name in enumerate(panel.feature_names):
        data[name] = panel.features[fi, ti, k]
    trailing = np.zeros_like(panel.returns)
    trailing[:, 1:] = panel.returns[:, :-1]
    data["ret"] = trailing[fi, ti]
    return pd.DataFrame(data)


def write_long_csv(panel: Panel, path: str) -> int:
    """:func:`to_long_frame`'s rows written as a CSV without pandas (the
    machine may have none): the same columns and rows, every float32
    value in 9 significant digits, which read back to the same float32.
    Returns the row count."""
    fi, ti = np.nonzero(panel.valid)
    trailing = np.zeros_like(panel.returns)
    trailing[:, 1:] = panel.returns[:, :-1]
    cols = ([panel.firm_ids[fi].astype(np.float64),
             panel.dates[ti].astype(np.float64)]
            + [panel.features[fi, ti, k].astype(np.float64)
               for k in range(panel.features.shape[2])]
            + [trailing[fi, ti].astype(np.float64)])
    header = ",".join(["gvkey", "yyyymm"] + list(panel.feature_names)
                      + ["ret"])
    fmt = ["%d", "%d"] + ["%.9g"] * (len(cols) - 2)
    np.savetxt(path, np.stack(cols, axis=1), fmt=fmt, delimiter=",",
               header=header, comments="")
    return int(fi.size)
