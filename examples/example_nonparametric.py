"""Non-parametric HOD inference: fit per-bin occupations to wp(rp).

The tabulation method makes the per-halo-bin mean occupations themselves
valid free parameters (PAPERS.md: arXiv 2603.18379): the predicted
statistic is an exact quadratic form in the occupation vector, so the
whole posterior — Gaussian wp data term + second-difference smoothness
prior — differentiates exactly and one Adam run recovers the occupation
function with no assumed functional form.  No reference counterpart
(the reference's predict consumes halotools models only).

Runs in a few seconds on CPU; the same code jit-compiles for a GPU.
"""

from pathlib import Path

import matplotlib as mpl
import matplotlib.pyplot as plt
import numpy as np

import jax
import jax.numpy as jnp

import tabcorr_tpu as tt
from tabcorr_tpu.models import smoothness_log_prior
from tabcorr_tpu.models.protocol import CENTRALS
from tabcorr_tpu.predictor import make_occupation_predictor

FIXTURE = (Path(__file__).absolute().parent.parent / "tests" / "data" /
           "examples" / "bolplanck_wp.hdf5")

halotab = tt.TabCorr.read(FIXTURE)

# --- synthetic "data": wp of a zheng07 truth model + 3% noise ----------
truth = tt.Zheng07Model(threshold=-18,
                        redshift=halotab.attrs["redshift"])
occ_truth = halotab.mean_occupation(truth)
ngal_t, wp_true = halotab.predict(truth)
rng = np.random.default_rng(42)
sigma = 0.03 * np.abs(wp_true)
wp_data = wp_true + sigma * rng.normal(size=wp_true.shape)

# --- non-parametric posterior over log10 occupations -------------------
np_model = tt.NonparametricHodModel.from_table(halotab)
n_cen = len(np_model.occupation_vector(CENTRALS))
f = make_occupation_predictor(halotab, dtype=jnp.float64, jit=False)
data = jnp.asarray(wp_data.ravel())
ivar = jnp.asarray(1.0 / sigma.ravel() ** 2)


def log_post(log_occ):
    occ = 10.0 ** log_occ
    _, wp = f(occ)
    chi2 = jnp.sum((wp.ravel() - data) ** 2 * ivar)
    return (-0.5 * chi2
            + smoothness_log_prior(occ[:n_cen], scale=0.35)
            + smoothness_log_prior(occ[n_cen:], scale=0.35))


# --- MAP via Adam (optax) ----------------------------------------------
import optax  # noqa: E402

x = jnp.asarray(np.full(halotab.n_bins, -1.5))
opt = optax.adam(3e-2)
state = opt.init(x)
step_fn = jax.jit(lambda x, s: _step(x, s))


def _step(x, s):
    lp, g = jax.value_and_grad(lambda v: -log_post(v))(x)
    updates, s = opt.update(g, s)
    return optax.apply_updates(x, updates), s, lp


for i in range(1500):
    x, state, nlp = step_fn(x, state)
    if i % 300 == 0:
        print(f"iter {i:5d}  -log post = {float(nlp):.2f}")

occ_fit = np.asarray(10.0 ** x)
_, wp_fit = f(jnp.asarray(occ_fit))

# --- plots --------------------------------------------------------------
mpl.use("Agg")
fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.5))
logm = 0.5 * (np.asarray(halotab.gal_type["log_prim_haloprop_min"]) +
              np.asarray(halotab.gal_type["log_prim_haloprop_max"]))
for sl, label in ((slice(0, n_cen), "centrals"),
                  (slice(n_cen, None), "satellites")):
    order = np.argsort(logm[sl])
    ax1.plot(logm[sl][order], occ_truth[sl][order], "-",
             label=f"truth {label}")
    ax1.plot(logm[sl][order], occ_fit[sl][order], "--",
             label=f"fit {label}")
ax1.set(xlabel=r"$\log_{10} M_{\rm vir}$", ylabel=r"$\langle N \rangle$",
        yscale="log", ylim=(1e-4, 50))
ax1.legend(fontsize=7)

rp = np.sqrt(halotab.tpcf_args[0][:-1] * halotab.tpcf_args[0][1:])
ax2.errorbar(rp, wp_data, yerr=sigma, fmt="o", ms=3, label="mock data")
ax2.plot(rp, np.asarray(wp_fit).ravel(), label="non-parametric fit")
ax2.set(xlabel=r"$r_p \ [h^{-1} \ \mathrm{Mpc}]$",
        ylabel=r"$w_p \ [h^{-1} \ \mathrm{Mpc}]$",
        xscale="log", yscale="log")
ax2.legend(fontsize=8)
fig.tight_layout()
fig.savefig(Path(__file__).with_suffix(".png"), dpi=150)
print("wrote", Path(__file__).with_suffix(".png"))
chi2 = float(np.sum((np.asarray(wp_fit).ravel() - wp_data.ravel()) ** 2
                    / sigma.ravel() ** 2))
print(f"final chi2 = {chi2:.1f} / {wp_data.size} bins")
