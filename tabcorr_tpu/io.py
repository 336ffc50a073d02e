"""HDF5 persistence helpers, compatible with the reference file format.

The reference stores tables via ``astropy.table.Table.write(..., path=...)``,
which produces a plain HDF5 dataset with a numpy structured dtype
(reference: tabcorr/tabcorr.py:414,463; tabcorr/interpolator.py:88-96,119).
We read and write the same layout with h5py directly, with no astropy
dependency, via a minimal column-oriented table type.  h5py is imported
only when an HDF5 file is opened, so the package imports without it.

The same tree also travels as a flat ``.npz`` archive (written by
``scripts/make_npz_fixtures.py``), which needs nothing beyond numpy to
read: each dataset is stored under its HDF5 path, each attribute under
``<group path>@<name>``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class ColumnTable:
    """Minimal ordered column table (astropy.table.Table stand-in).

    Stores named 1-D numpy columns of equal length.  Supports the small
    subset of operations the tabulation/interpolation layers need: column
    access/assignment, boolean-mask row selection, vertical stacking, sort,
    and HDF5 round-tripping in the reference's structured-dataset layout.
    """

    def __init__(self, data=None):
        self._cols: dict[str, np.ndarray] = {}
        if data is not None:
            for key, value in data.items():
                self[key] = value

    # -- dict-like column interface ------------------------------------
    @property
    def colnames(self) -> list[str]:
        return list(self._cols.keys())

    def __contains__(self, key):
        return key in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        # Row selection with a mask / index array -> new table.
        out = ColumnTable()
        for name, col in self._cols.items():
            out._cols[name] = col[key]
        return out

    def __setitem__(self, key, value):
        value = np.asarray(value)
        if value.ndim == 0:
            value = np.repeat(value, len(self)) if self._cols else value[None]
        if self._cols and len(value) != len(self):
            raise ValueError(
                f"Column {key!r} has length {len(value)}, expected "
                f"{len(self)}.")
        self._cols[key] = value

    def __len__(self):
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __iter__(self):
        return iter(self._cols)

    def remove_column(self, key):
        del self._cols[key]

    def copy(self):
        out = ColumnTable()
        for name, col in self._cols.items():
            out._cols[name] = col.copy()
        return out

    def sort(self, keys):
        if isinstance(keys, str):
            keys = [keys]
        order = np.lexsort([self._cols[k] for k in reversed(keys)])
        for name in self._cols:
            self._cols[name] = self._cols[name][order]

    # -- conversion ------------------------------------------------------
    def as_structured_array(self) -> np.ndarray:
        dtype = [(name, col.dtype, col.shape[1:])
                 for name, col in self._cols.items()]
        out = np.empty(len(self), dtype=dtype)
        for name, col in self._cols.items():
            out[name] = col
        return out

    @classmethod
    def from_structured_array(cls, arr: np.ndarray) -> "ColumnTable":
        out = cls()
        for name in arr.dtype.names:
            out._cols[name] = np.ascontiguousarray(arr[name])
        return out

    def as_array(self):
        return self.as_structured_array()

    # -- HDF5 ------------------------------------------------------------
    def write_hdf5(self, group, path: str):
        """Write as a structured dataset (reference/astropy layout)."""
        group[path] = self.as_structured_array()

    @classmethod
    def read_hdf5(cls, source, path: str) -> "ColumnTable":
        """Read a structured dataset written by astropy or by this module."""
        if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
            with open_tree(source) as fstream:
                return cls.from_structured_array(fstream[path][()])
        return cls.from_structured_array(source[path][()])

    def __repr__(self):
        cols = ", ".join(f"{k}[{v.dtype}]" for k, v in self._cols.items())
        return f"ColumnTable(len={len(self)}, cols=({cols}))"


def vstack(tables) -> ColumnTable:
    """Stack tables with identical columns vertically."""
    out = ColumnTable()
    first = tables[0]
    for name in first.colnames:
        out[name] = np.concatenate([t[name] for t in tables])
    return out


def read_attrs(group) -> dict:
    """Read HDF5 attributes, decoding bytes to str for convenience keys."""
    attrs = {}
    for key in group.attrs.keys():
        value = group.attrs[key]
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        attrs[key] = value
    return attrs


class NpzTree:
    """Read-only HDF5-group view of a flattened ``.npz`` tree.

    Supports what the readers use: ``attrs``, item access to datasets
    (numpy arrays, so ``[()]`` works) and subgroups, ``in`` and
    iteration over child names.
    """

    def __init__(self, data, prefix=""):
        self._data = data
        self._prefix = prefix

    @property
    def attrs(self):
        head = self._prefix + "@"
        return {key[len(head):]: (value.item() if value.ndim == 0 else value)
                for key, value in self._data.items()
                if key.startswith(head)}

    def _children(self):
        names = []
        for key in self._data:
            if key.startswith(self._prefix):
                name = key[len(self._prefix):].split("/")[0]
                if "@" not in name and name not in names:
                    names.append(name)
        return sorted(names)   # h5py's (name) order

    def __contains__(self, key):
        return key in self._children()

    def __iter__(self):
        return iter(self._children())

    def __getitem__(self, key):
        full = self._prefix + key
        if full in self._data:
            return self._data[full]
        if key not in self:
            raise KeyError(key)
        return NpzTree(self._data, full + "/")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def open_tree(path, mode="r"):
    """Open an HDF5 file, or a ``.npz`` tree (read-only), as a group."""
    if Path(path).suffix == ".npz":
        if mode != "r":
            raise ValueError(".npz trees are read-only.")
        with np.load(path) as archive:
            return NpzTree({key: archive[key] for key in archive.files})
    import h5py
    return h5py.File(path, mode)


def is_group(obj) -> bool:
    """True for an open HDF5 group or :class:`NpzTree` (not a path)."""
    return hasattr(obj, "attrs") and hasattr(obj, "__getitem__")
