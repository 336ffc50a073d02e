"""Synthetic tabulations and halo catalogues made from a seed.

Used by ``bench.py``, ``chip_smoke.py`` and the tests where a shape
matters more than the contents: random tables with the published
layouts, the published 'default' 64-node grid geometry, and a halo
catalogue at the published tabulation scale.
"""

from __future__ import annotations

import numpy as np

from .io import ColumnTable
from .utils.packing import symmetric_matrix_to_array


def synthetic_tabcorr(rng, n_prim, n_sec, n_xi, mode):
    """A structurally valid TabCorr with random contents.

    Row amplitudes span ~6 decades; matrix values are positive-dominant
    and symmetric (the sign structure of a real correlation matrix).
    """
    from .table import TabCorr

    n_half = n_prim * n_sec
    n_bins = 2 * n_half
    log_m = np.linspace(11.0, 14.5, n_prim + 1)
    gal_type = ColumnTable()
    gal_type["n_h"] = np.tile(
        10.0 ** -np.linspace(0, 4, n_half), 2) * 1e-3
    gal_type["log_prim_haloprop_min"] = np.tile(
        np.repeat(log_m[:-1], n_sec), 2)
    gal_type["log_prim_haloprop_max"] = np.tile(
        np.repeat(log_m[1:], n_sec), 2)
    sec = (np.arange(n_sec) + 0.5) / n_sec
    gal_type["sec_haloprop_percentile_min"] = np.tile(
        np.tile(sec - 0.5 / n_sec, n_prim), 2)
    gal_type["sec_haloprop_percentile_max"] = np.tile(
        np.tile(sec + 0.5 / n_sec, n_prim), 2)
    gal_type["sec_haloprop_percentile"] = np.tile(np.tile(sec, n_prim), 2)
    gal_type["prim_haloprop"] = 10.0 ** (
        0.5 * (gal_type["log_prim_haloprop_min"] +
               gal_type["log_prim_haloprop_max"]))
    gal_type["prim_haloprop_dist_index"] = rng.uniform(-2, 2, n_bins)
    gal_type["gal_type"] = np.concatenate(
        [np.repeat(b"centrals", n_half), np.repeat(b"satellites", n_half)])

    row_amp = 10.0 ** rng.uniform(-5, 1, n_xi)
    if mode == "auto":
        base = rng.uniform(0.2, 1.0, (n_xi, n_bins, n_bins))
        base = 0.5 * (base + np.transpose(base, (0, 2, 1)))
        dense = base * row_amp[:, None, None]
        matrix = np.stack([symmetric_matrix_to_array(dense[k])
                           for k in range(n_xi)])
    else:
        matrix = rng.uniform(0.2, 1.0, (n_xi, n_bins)) * row_amp[:, None]

    halotab = TabCorr()
    halotab.gal_type = gal_type
    halotab.attrs = {"mode": mode, "tpcf": "synthetic", "redshift": 0.0,
                     "simname": "prop", "Num_ptcl_requirement": 300,
                     "prim_haloprop_key": "halo_mvir",
                     "sec_haloprop_key": "halo_nfw_conc"}
    halotab.tpcf_args = ()
    halotab.tpcf_kwargs = {}
    halotab.tpcf_shape = (n_xi,)
    halotab.tpcf_matrix = matrix
    return halotab


def build_interpolator(n_nodes=64, n_prim=30, n_xi=42, seed=42):
    """Interpolator with the published 'default' grid geometry.

    4 x 4 x 4 = 64 phase-space nodes (alpha_c, alpha_s, log_eta;
    reference: tabcorr/database.py:56-59), 30 primary-property bins x 2
    galaxy types = 60 halo bins, and xi_0/2/4 x 14 separation bins = 42
    statistic rows per node.  The nodes share one binning and differ by
    10% random perturbations of one random table.
    """
    from .interpolator import Interpolator

    tabs = []
    for j in range(n_nodes):
        t = synthetic_tabcorr(np.random.default_rng(seed), n_prim, 1,
                              n_xi, "auto")
        r2 = np.random.default_rng(1000 + j)
        t.tpcf_matrix = t.tpcf_matrix * (
            1.0 + 0.1 * r2.normal(size=t.tpcf_matrix.shape))
        t.tpcf_shape = (3, n_xi // 3)
        tabs.append(t)
    pt = ColumnTable()
    side = round(n_nodes ** (1 / 3))
    ac, as_, le = np.meshgrid(np.linspace(0, .4, side),
                              np.linspace(.8, 1.2, side),
                              np.linspace(-.4, .4, side), indexing="ij")
    pt["alpha_c"] = ac.ravel()
    pt["alpha_s"] = as_.ravel()
    pt["log_eta"] = le.ravel()
    return Interpolator(tabs, pt)


def synthetic_halocat(n_halos, lbox, seed, log_m_min=11.5, log_m_max=15.0,
                      slope=-0.9):
    """Host halos uniform in a periodic box with a power-law mass function.

    ``dn/dlogM ~ M^slope`` between the mass bounds; concentrations are
    log-normal around a c(M) relation, velocities Gaussian.  Particle
    mass 1e9 Msun/h, so every halo passes a 300-particle cut.
    """
    from .cosmology import FlatFLRW
    from .halocat import HaloCatalog

    rng = np.random.default_rng(seed)
    u = rng.uniform(size=n_halos)
    lo, hi = 10.0 ** (slope * log_m_min), 10.0 ** (slope * log_m_max)
    mass = (lo + u * (hi - lo)) ** (1.0 / slope)
    cosmo = FlatFLRW(H0=70, Om0=0.3, Tcmb0=0, Neff=0)
    rho_m = cosmo.critical_density(0.0) * cosmo.Om0 / cosmo.h ** 2
    rvir = (3 * mass / (4 * np.pi * 200 * rho_m)) ** (1.0 / 3.0)
    conc = 10.0 ** (np.log10(9.0 * (mass / 1e12) ** -0.1) +
                    0.15 * rng.normal(size=n_halos))
    pos = rng.uniform(0.0, lbox, size=(n_halos, 3))
    vel = 300.0 * rng.normal(size=(n_halos, 3))
    table = {"halo_x": pos[:, 0], "halo_y": pos[:, 1], "halo_z": pos[:, 2],
             "halo_vx": vel[:, 0], "halo_vy": vel[:, 1],
             "halo_vz": vel[:, 2], "halo_mvir": mass, "halo_rvir": rvir,
             "halo_nfw_conc": conc,
             "halo_upid": np.full(n_halos, -1, dtype=np.int64)}
    return HaloCatalog(table, Lbox=lbox, particle_mass=1e9, redshift=0.0,
                       cosmology=cosmo, simname="synthetic")
