"""HDF5 spectra and stellar-parameter tables in the reference's key schema
(port of ``vit_tpu/data/hdf5.py``). ``h5py`` is imported when a file is read.

``read_params_table`` tries ``pd.read_hdf`` (when PyTables is installed),
then parses the PyTables *table* and pandas *fixed* layouts with h5py, then
a flat ``params/<column>`` group (what ``write_dummy_h5`` writes)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["load_spectra", "read_params_table", "PARAM_COLUMNS", "WAVE_KEY", "FLUX_KEY",
           "ERROR_KEY"]

# Columns present in the upstream BOSZ parameter tables.
PARAM_COLUMNS = ("redshift", "mag", "snr", "T_eff", "M_H", "a_M", "C_M", "log_g")

WAVE_KEY = "spectrumdataset/wave"
FLUX_KEY = "dataset/arrays/flux/value"
ERROR_KEY = "dataset/arrays/error/value"


def load_spectra(path: str, num_samples: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Load ``{wave, flux, error?}`` as float32 arrays; ``num_samples``
    truncates the sample axis (``None``/-1 = all)."""
    import h5py

    n = None if (num_samples is None or num_samples == -1) else int(num_samples)
    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        out["wave"] = np.asarray(f[WAVE_KEY][()], dtype=np.float32)
        out["flux"] = np.asarray(f[FLUX_KEY][:n], dtype=np.float32)
        if ERROR_KEY in f:
            out["error"] = np.asarray(f[ERROR_KEY][:n], dtype=np.float32)
    return out


def _decode(x):
    return x.decode() if isinstance(x, bytes) else x


def _read_pytables_table(f, key: str) -> Optional[Dict[str, np.ndarray]]:
    """Parse a PyTables 'table' format group: ``<key>/table`` structured array."""
    import h5py

    grp = f.get(key)
    if not isinstance(grp, h5py.Group) or "table" not in grp:
        return None
    table = grp["table"][()]
    names = table.dtype.names or ()
    cols: Dict[str, np.ndarray] = {}
    for name in names:
        if name == "index":
            continue
        col = table[name]
        if col.ndim == 2 and col.shape[1] == 1:
            col = col[:, 0]
        cols[_decode(name)] = np.asarray(col)
    return cols or None


def _read_pandas_fixed(f, key: str) -> Optional[Dict[str, np.ndarray]]:
    """Parse a pandas 'fixed' format frame group (axis0 + blockN_items/values)."""
    import h5py

    grp = f.get(key)
    if not isinstance(grp, h5py.Group) or "axis0" not in grp:
        return None
    cols: Dict[str, np.ndarray] = {}
    i = 0
    while f"block{i}_items" in grp and f"block{i}_values" in grp:
        items = [_decode(c) for c in grp[f"block{i}_items"][()]]
        values = np.asarray(grp[f"block{i}_values"][()])
        # pandas BlockManagerFixed stores block values as (n_items, n_rows)
        # and reads them back with values.T — column j is row j here.
        for j, name in enumerate(items):
            cols[name] = values[j] if values.ndim == 2 else values
        i += 1
    return cols or None


def _read_flat_params(f) -> Optional[Dict[str, np.ndarray]]:
    """Flat layout: 1-D datasets under a ``params/`` group."""
    import h5py

    grp = f.get("params")
    if not isinstance(grp, h5py.Group):
        return None
    cols = {
        name: np.asarray(ds[()])
        for name, ds in grp.items()
        if isinstance(ds, h5py.Dataset)
    }
    return cols or None


def read_params_table(
    path: str, num_samples: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Read the stellar-parameter table as ``{column: 1-D array}``.

    Resolution order: ``pd.read_hdf`` (if PyTables is installed) -> direct
    h5py parse of PyTables table / pandas fixed layouts -> flat ``params/``
    group. Raises ``KeyError`` when no parameter table is found.
    """
    n = None if (num_samples is None or num_samples == -1) else int(num_samples)

    try:  # Fast path when the optional pytables dependency exists.
        import tables  # noqa: F401
        import pandas as pd

        df = pd.read_hdf(path)
        if n is not None:
            df = df[:n]
        return {str(c): df[c].to_numpy() for c in df.columns}
    except Exception:
        # Missing pytables, or a file pd.read_hdf cannot interpret (e.g. the
        # raw-h5py layouts below) — continue down the fallback chain.
        pass

    import h5py

    with h5py.File(path, "r") as f:
        cols = _read_flat_params(f)
        if cols is None:
            # Probe every top-level group for pytables/pandas layouts.
            for key in f.keys():
                cols = _read_pytables_table(f, key) or _read_pandas_fixed(f, key)
                if cols:
                    break
    if not cols:
        raise KeyError(f"No stellar-parameter table found in {path}")
    if n is not None:
        cols = {k: v[:n] for k, v in cols.items()}
    return cols
