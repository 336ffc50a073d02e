"""HDF5 round-trip, schema-compatibility and .npz-copy tests."""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

import tabcorr_tpu as tt
from tabcorr_tpu.io import ColumnTable


def _assert_tabcorr_equal(a, b, matrix_rtol=0.0):
    for key in ["tpcf", "mode", "simname", "redshift",
                "Num_ptcl_requirement", "prim_haloprop_key",
                "sec_haloprop_key"]:
        assert a.attrs[key] == b.attrs[key], key
    np.testing.assert_allclose(a.tpcf_matrix, b.tpcf_matrix,
                               rtol=matrix_rtol)
    assert a.tpcf_shape == b.tpcf_shape
    assert a.gal_type.colnames == b.gal_type.colnames
    for col in a.gal_type.colnames:
        np.testing.assert_array_equal(a.gal_type[col], b.gal_type[col])


def test_tabcorr_roundtrip(wp_tabcorr, tmp_path):
    path = tmp_path / "roundtrip.hdf5"
    wp_tabcorr.write(path)
    again = tt.TabCorr.read(path)
    # Matrix stored float32 like the reference; source was float32 on disk
    # already so the round trip is exact.
    _assert_tabcorr_equal(wp_tabcorr, again)


def test_tabcorr_write_schema_matches_reference(wp_tabcorr, tmp_path):
    # The written file must use the reference's exact HDF5 layout
    # (tabcorr/tabcorr.py:438-463) so the original package can read it.
    path = tmp_path / "schema.hdf5"
    wp_tabcorr.write(path)
    with h5py.File(path, "r") as f:
        for key in ["tpcf", "mode", "simname", "redshift",
                    "Num_ptcl_requirement", "prim_haloprop_key",
                    "sec_haloprop_key"]:
            assert key in f.attrs
        assert f["tpcf_matrix"].dtype == np.float32
        assert f["tpcf_matrix"].shape == wp_tabcorr.tpcf_matrix.shape
        assert "tpcf_shape" in f
        assert "tpcf_args/arg_0" in f
        gal_type = f["gal_type"][()]
        assert "n_h" in gal_type.dtype.names
        assert "gal_type" in gal_type.dtype.names


def test_tabcorr_overwrite_guard(wp_tabcorr, tmp_path):
    path = tmp_path / "guard.hdf5"
    wp_tabcorr.write(path)
    try:
        wp_tabcorr.write(path)
        raised = False
    except (OSError, FileExistsError):
        raised = True
    assert raised
    wp_tabcorr.write(path, overwrite=True)


def test_max_args_size(ds_tabcorr, tmp_path):
    # Large tpcf args (e.g. the particle catalog) are dropped on write
    # (reference: tabcorr/tabcorr.py:450-457).
    halotab = tt.TabCorr.read(
        __file__.replace("test_io.py", "data/examples/bolplanck_ds.hdf5"))
    halotab.tpcf_args = (np.zeros((10, 3)),) + halotab.tpcf_args
    path = tmp_path / "args.hdf5"
    halotab.write(path, max_args_size=5)
    with h5py.File(path, "r") as f:
        assert "arg_0" not in f["tpcf_args"]
        assert "arg_1" in f["tpcf_args"]


def test_interpolator_roundtrip(ds_interpolator, tmp_path):
    path = tmp_path / "interp.hdf5"
    ds_interpolator.write(path)
    again = tt.Interpolator.read(path)
    assert again.keys == ds_interpolator.keys
    np.testing.assert_array_equal(again.xp[0], ds_interpolator.xp[0])
    for a, b in zip(again.tabcorr_list, ds_interpolator.tabcorr_list):
        _assert_tabcorr_equal(a, b)


def test_column_table_ops():
    table = ColumnTable({"a": np.array([3, 1, 2]),
                         "b": np.array([30.0, 10.0, 20.0])})
    table.sort("a")
    np.testing.assert_array_equal(table["a"], [1, 2, 3])
    np.testing.assert_array_equal(table["b"], [10.0, 20.0, 30.0])
    sel = table[table["a"] > 1]
    assert len(sel) == 2
    copy = table.copy()
    copy["a"][0] = 99
    assert table["a"][0] == 1
    table.remove_column("b")
    assert table.colnames == ["a"]


REPO = Path(__file__).absolute().parent.parent
NPZ_FIXTURES = (
    "tests/data/examples/bolplanck_wp",
    "tests/data/examples/synthetic_xi_ell",
    "tests/data/AbacusSummit/base_c000_ph000/0p50/ds_efficient",
)


@pytest.mark.parametrize("stem", NPZ_FIXTURES)
def test_npz_copy_matches_hdf5(stem):
    # The committed .npz copies (scripts/make_npz_fixtures.py) read back
    # to the same objects as their HDF5 originals.
    reader = (tt.Interpolator.read if "AbacusSummit" in stem
              else tt.TabCorr.read)
    a = reader(REPO / f"{stem}.hdf5")
    b = reader(REPO / f"{stem}.npz")
    if isinstance(a, tt.Interpolator):
        assert a.keys == b.keys
        for col in a.param_dict_table.colnames:
            np.testing.assert_array_equal(a.param_dict_table[col],
                                          b.param_dict_table[col])
        pairs = zip(a.tabcorr_list, b.tabcorr_list)
    else:
        pairs = [(a, b)]
    for x, y in pairs:
        _assert_tabcorr_equal(x, y)
        for u, v in zip(x.tpcf_args, y.tpcf_args):
            np.testing.assert_array_equal(u, v)
        assert x.tpcf_kwargs.keys() == y.tpcf_kwargs.keys()


def test_npz_tree_is_read_only(tmp_path):
    from tabcorr_tpu.io import open_tree
    with pytest.raises(ValueError):
        open_tree(tmp_path / "x.npz", "w")


def test_database_read_prefers_npz(monkeypatch):
    seen = []
    monkeypatch.setattr(tt.Interpolator, "read",
                        classmethod(lambda cls, path: seen.append(path)))
    tt.database.read("AbacusSummit", 0.5, "ds", tab_config="efficient")
    assert seen[0].suffix == ".npz"


def test_package_reads_npz_without_h5py():
    # h5py is imported only when an HDF5 file is opened.
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import tabcorr_tpu as tt\n"
        "tab = tt.TabCorr.read(sys.argv[1])\n"
        "assert tab.tpcf_matrix.shape == (19, 1830), tab.tpcf_matrix.shape\n"
        "print('ok')\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", code,
         str(REPO / "tests/data/examples/bolplanck_wp.npz")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
