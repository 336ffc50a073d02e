"""Test configuration.

Tests run on CPU with 8 virtual XLA devices (to exercise multi-device
sharding without accelerators) and float64 enabled (the parity paths
mirror the reference's float64 numpy math).  Environment variables must be
set before jax initializes its backends.  Tests that only a GPU can run
carry the ``gpu`` marker and skip elsewhere; ``chip_smoke.py`` runs the
same paths on the card.
"""

import os
from pathlib import Path

# Force CPU with 8 virtual devices.  JAX may already be imported when this
# conftest runs, so plain env vars can be too late — jax.config.update
# works as long as no backend client has been initialized yet.  Set
# TABCORR_TEST_ACCELERATOR=1 to keep the real device (useful for the slow
# pair-counting golden tests).
USE_ACCELERATOR = bool(os.environ.get("TABCORR_TEST_ACCELERATOR"))

if not USE_ACCELERATOR:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

DATA_DIR = Path(__file__).absolute().parent / "data"
os.environ["TABCORR_DATABASE"] = str(DATA_DIR)

import jax  # noqa: E402

if not USE_ACCELERATOR:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", (
        "tests must run on CPU; a backend was initialized before conftest")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import tabcorr_tpu as tt  # noqa: E402
from tabcorr_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

SUITE = "AbacusSummit"
REDSHIFT = 0.5
COSMO = 0


@pytest.fixture(scope="session")
def wp_tabcorr():
    """The reference's example wp tabulation (auto mode, 60 bins)."""
    return tt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5")


@pytest.fixture(scope="session")
def ds_tabcorr():
    """The reference's example delta-sigma tabulation (cross mode)."""
    return tt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_ds.hdf5")


@pytest.fixture(scope="session")
def ds_interpolator():
    """The reference's checked-in ds 'efficient' Interpolator fixture."""
    return tt.database.read(SUITE, REDSHIFT, "ds", tab_config="efficient",
                            i_cosmo=COSMO)


@pytest.fixture
def model():
    """Zheng07 model matching the reference test fixture (conftest.py:27-36)."""
    m = tt.Zheng07Model(threshold=-21, redshift=0.5,
                        prim_haloprop_key="halo_m258m")
    m.param_dict["log_eta"] = 0.0
    m.param_dict["alpha_s"] = 1.0
    m.param_dict["alpha_c"] = 0.0
    return m


@pytest.fixture
def bol_model(wp_tabcorr):
    return tt.Zheng07Model(threshold=-18,
                           redshift=wp_tabcorr.attrs["redshift"])


def reference_mean_occupation(halotab, model, n_gauss_prim=10):
    """Literal float64 transcription of the reference quadrature.

    Mirrors tabcorr/tabcorr.py:537-578 step by step (including the raw
    M^(n+1) measure without rescaling) as an independent oracle for the
    package's precomputed-weight formulation.
    """
    gt = halotab.gal_type
    log_min = np.asarray(gt["log_prim_haloprop_min"], dtype=np.float64)
    log_max = np.asarray(gt["log_prim_haloprop_max"], dtype=np.float64)
    d_log = log_max - log_min
    sec = np.asarray(gt["sec_haloprop_percentile"], dtype=np.float64)
    gal_type = gt["gal_type"]
    is_cen = gal_type == b"centrals"

    x_gauss, w_gauss = np.polynomial.legendre.leggauss(n_gauss_prim)
    x_gauss = (x_gauss + 1) / 2

    prim = 10 ** (log_min + d_log * x_gauss[:, np.newaxis]).T.ravel()
    sec_rep = np.repeat(sec, n_gauss_prim)
    cen_rep = np.repeat(is_cen, n_gauss_prim)

    occ = np.zeros(len(prim))
    occ[cen_rep] = model.mean_occupation_centrals(
        prim_haloprop=prim[cen_rep],
        sec_haloprop_percentile=sec_rep[cen_rep])
    occ[~cen_rep] = model.mean_occupation_satellites(
        prim_haloprop=prim[~cen_rep],
        sec_haloprop_percentile=sec_rep[~cen_rep])
    occ = occ.reshape((len(gt), n_gauss_prim))
    prim = prim.reshape(occ.shape)

    n = np.asarray(gt["prim_haloprop_dist_index"],
                   dtype=np.float64)[:, np.newaxis] + 1

    return (np.sum(w_gauss * occ * prim**n, axis=-1) /
            np.sum(w_gauss * prim**n, axis=-1))


def reference_predict(halotab, mean_occ):
    """Literal float64 transcription of the reference packed contraction.

    Mirrors tabcorr/tabcorr.py:623-650 using the packed tpcf_matrix and
    explicit (2 - delta) pair weights, as an independent oracle for the
    package's dense quadratic-form formulation.
    """
    ngal = mean_occ * np.asarray(halotab.gal_type["n_h"], dtype=np.float64)
    matrix = halotab.tpcf_matrix

    if halotab.attrs["mode"] == "auto":
        n_bins = len(halotab.gal_type)
        idx_1 = np.concatenate(
            [np.full(i + 1, i) for i in range(n_bins)])
        idx_2 = np.concatenate(
            [np.arange(i + 1) for i in range(n_bins)])
        prefactor = np.where(idx_1 == idx_2, 1.0, 2.0)
        ngal_sq = prefactor * ngal[idx_1] * ngal[idx_2]
        xi = matrix @ ngal_sq / np.sum(ngal_sq)
    else:
        xi = matrix @ ngal / np.sum(ngal)
    return np.sum(ngal), xi.reshape(halotab.tpcf_shape)
