"""Write ``.npz`` copies of the HDF5 tables that the main path loads.

The copies read without h5py (see ``tabcorr_tpu.io.NpzTree``): every
dataset is stored under its HDF5 path, every attribute under
``<group path>@<name>``.  Run from the repository root after changing a
fixture:

    python scripts/make_npz_fixtures.py
"""

import sys
from pathlib import Path

import h5py
import numpy as np

REPO = Path(__file__).absolute().parent.parent
FIXTURES = (
    "tests/data/examples/bolplanck_wp.hdf5",
    "tests/data/examples/synthetic_xi_ell.hdf5",
    "tests/data/AbacusSummit/base_c000_ph000/0p50/ds_efficient.hdf5",
)


def flatten(path):
    """{key: array} for every dataset and attribute under the file."""
    out = {}

    def add_attrs(prefix, obj):
        for name, value in obj.attrs.items():
            out[f"{prefix}@{name}"] = np.asarray(value)

    with h5py.File(path, "r") as fstream:
        add_attrs("", fstream)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                value = obj[()]
                if isinstance(value, np.ndarray):
                    # h5py tags string fields with dtype metadata, which
                    # .npy cannot hold; the plain dtype is the same layout.
                    dtype = value.dtype
                    value = value.astype(
                        [(n, dtype[n].str) for n in dtype.names]
                        if dtype.names else dtype.str)
                out[name] = value
            add_attrs(name + "/", obj)

        fstream.visititems(visit)
    return out


def main(paths=FIXTURES):
    for rel in paths:
        src = REPO / rel
        np.savez_compressed(src.with_suffix(".npz"), **flatten(src))
        print(src.with_suffix(".npz"))


if __name__ == "__main__":
    main(sys.argv[1:] or FIXTURES)
