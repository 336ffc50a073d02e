"""Projected clustering example (counterpart of the reference's
docs/examples/example_wp.py).

Tabulates wp(rp) for a halo catalog, saves/loads the tabulation, and plots
the prediction decomposed by galaxy type plus its dependence on logM1.
Uses the reference's own bolplanck example tabulation if present; otherwise
tabulates a synthetic catalog from scratch.
"""

from pathlib import Path

import matplotlib as mpl
import matplotlib.pyplot as plt
import numpy as np

import tabcorr_tpu as tt

FIXTURE = (Path(__file__).absolute().parent.parent / "tests" / "data" /
           "examples" / "bolplanck_wp.hdf5")

if FIXTURE.exists():
    halotab = tt.TabCorr.read(FIXTURE)
    rp_bins = halotab.tpcf_args[0]
else:
    # Tabulate from scratch on a synthetic catalog. With a real simulation,
    # build the HaloCatalog from your halo finder output instead.
    rng = np.random.default_rng(0)
    n = 20000
    mass = 10.0 ** rng.uniform(11.5, 14.5, n)
    halocat = tt.HaloCatalog(
        {"halo_x": rng.uniform(0, 250, n), "halo_y": rng.uniform(0, 250, n),
         "halo_z": rng.uniform(0, 250, n),
         "halo_vx": 300 * rng.normal(size=n),
         "halo_vy": 300 * rng.normal(size=n),
         "halo_vz": 300 * rng.normal(size=n), "halo_mvir": mass,
         "halo_rvir": 0.3 * (mass / 1e13) ** (1 / 3),
         "halo_nfw_conc": np.clip(9 * (mass / 1e13) ** -0.1, 2, 25)},
        Lbox=250.0, particle_mass=1e8, redshift=0.0,
        cosmology=tt.cosmology.Planck15, simname="synthetic")
    rp_bins = np.logspace(-1, 1, 20)
    halotab = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp_bins,
                                  pi_max=40, verbose=True, seed=0)
    halotab.write("example_wp.hdf5", overwrite=True)
    halotab = tt.TabCorr.read("example_wp.hdf5")

model = tt.Zheng07Model(threshold=-18,
                        redshift=halotab.attrs["redshift"],
                        prim_haloprop_key=halotab.attrs["prim_haloprop_key"])

rp_ave = 0.5 * (rp_bins[1:] + rp_bins[:-1])

ngal, wp = halotab.predict(model)
plt.plot(rp_ave, wp, label="total")

ngal_sep, wp_sep = halotab.predict(model, separate_gal_type=True)
for key, value in wp_sep.items():
    plt.plot(rp_ave, value, label=key, ls="--")

plt.xscale("log")
plt.yscale("log")
plt.xlabel(r"$r_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
plt.ylabel(r"$w_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
plt.legend(loc="lower left", frameon=False)
plt.tight_layout(pad=0.3)
plt.savefig("wp_decomposition.png", dpi=300)
plt.close()

# Parameter dependence: here's where the batched path shines — all 1000 models
# evaluate in ONE batched kernel call instead of a Python loop.
from tabcorr_tpu.predictor import make_predictor, params_batch

predict = make_predictor(halotab, model)
logm1 = np.linspace(12.0, 12.8, 1000)
params = params_batch(model, {"logM1": logm1}, (1000,))
ngal_batch, wp_batch = predict(params)

sm = mpl.cm.ScalarMappable(cmap=mpl.cm.viridis,
                           norm=mpl.colors.Normalize(vmin=12.0, vmax=12.8))
for i in range(1000):
    plt.plot(rp_ave, wp_batch[i], color=sm.to_rgba(logm1[i]), lw=0.1)
cb = plt.colorbar(sm, ax=plt.gca())
cb.set_label(r"$\log M_1$")
plt.xscale("log")
plt.yscale("log")
plt.xlabel(r"$r_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
plt.ylabel(r"$w_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
plt.tight_layout(pad=0.3)
plt.savefig("wp_vs_logm1.png", dpi=300)
plt.close()
print("wrote wp_decomposition.png, wp_vs_logm1.png")
