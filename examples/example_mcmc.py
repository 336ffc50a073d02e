"""End-to-end on-device MCMC example: fit zheng07 wp(rp) data.

Generates synthetic wp data at known HOD parameters, then samples the
posterior with the vmapped stretch-move ensemble sampler — every walker
update is one jitted kernel over the whole ensemble (BASELINE config #5).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np

import tabcorr_tpu as tt
from tabcorr_tpu.mcmc import make_gaussian_logpost_batched, run_ensemble
from tabcorr_tpu.predictor import make_multi_predictor

FIXTURE = (Path(__file__).absolute().parent.parent / "tests" / "data" /
           "examples" / "bolplanck_wp.hdf5")

halotab = tt.TabCorr.read(FIXTURE)
model = tt.Zheng07Model(threshold=-18, redshift=halotab.attrs["redshift"])

# Synthetic data: the prediction at the true parameters + 3% errors.
truth = {"logMmin": 11.45, "logM1": 12.5, "alpha": 0.9}
for key, value in truth.items():
    model.param_dict[key] = value
ngal_true, wp_true = halotab.predict(model)
sigma = 0.03 * np.abs(wp_true)
inv_cov = np.diag(1.0 / sigma**2)
rng = np.random.default_rng(0)
wp_data = wp_true + sigma * rng.normal(size=len(wp_true))

# Posterior over three parameters; the others stay at their defaults.
names = ("logMmin", "logM1", "alpha")
base = {k: jnp.float32(v) for k, v in model.param_dict.items()}
bounds = {"logMmin": (10.5, 12.5), "logM1": (11.5, 13.5),
          "alpha": (0.3, 1.6)}
n_walkers = 256
walkers0 = jnp.asarray(
    np.array([truth[k] for k in names])[None]
    + 0.05 * rng.normal(size=(n_walkers, len(names))), dtype=jnp.float32)

# One batched call evaluates the whole half-ensemble's likelihood (the
# sampler proposes one half against the other).  A number-density
# constraint breaks the logMmin-logM1 degeneracy.
predict_all = make_multi_predictor([halotab], model)
log_prob = make_gaussian_logpost_batched(
    predict_all, names, base, [wp_data], [inv_cov],
    ngal_data=ngal_true, ngal_sigma=0.02 * ngal_true, bounds=bounds)

chain, log_p, accept = run_ensemble(
    jax.random.key(1), log_prob, walkers0, n_steps=500, vectorized=True)
samples = np.asarray(chain[200:]).reshape(-1, len(names))
print(f"acceptance fraction: {float(accept):.2f}")
for i, name in enumerate(names):
    print(f"{name}: {samples[:, i].mean():.3f} +- "
          f"{samples[:, i].std():.3f}   (truth {truth[name]})")

fig, axes = plt.subplots(1, 3, figsize=(9, 3))
for i, (ax, name) in enumerate(zip(axes, names)):
    ax.hist(samples[:, i], bins=40, histtype="step")
    ax.axvline(truth[name], color="k", ls="--")
    ax.set_xlabel(name)
plt.tight_layout(pad=0.3)
plt.savefig("mcmc_posterior.png", dpi=200)
print("wrote mcmc_posterior.png")
