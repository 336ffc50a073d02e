"""Fisher forecast through the differentiable predictor.

The reference's ``predict`` is a numpy pipeline, so parameter derivatives
need finite differences.  Here ``predict`` is a pure jax function, so the
Jacobian d(wp)/d(theta) is exact to machine precision via ``jax.jacfwd``
and one line builds the Fisher matrix

    F_ab = sum_ij  (d wp_i / d theta_a)  C^-1_ij  (d wp_j / d theta_b)

for a 5-parameter zheng07 HOD — the standard survey-forecast computation
(expected parameter covariance = F^-1), plus an ngal prior as a bonus row.
Runs on CPU or GPU; uses the checked-in bolplanck wp tabulation.
"""

from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)  # clean f64 derivatives

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tabcorr_tpu as tt  # noqa: E402
from tabcorr_tpu.predictor import make_predictor  # noqa: E402

FIXTURE = (Path(__file__).absolute().parent.parent / "tests" / "data" /
           "examples" / "bolplanck_wp.hdf5")

halotab = tt.TabCorr.read(FIXTURE)
model = tt.Zheng07Model(threshold=-18, redshift=halotab.attrs["redshift"])
names = tuple(model.param_dict.keys())
theta0 = jnp.asarray([model.param_dict[k] for k in names], jnp.float64)

# Vector-in, vector-out prediction; float64 for clean derivatives.
predict = make_predictor(halotab, model, dtype=jnp.float64,
                         vectorized=False)


def observables(theta):
    ngal, wp = predict(dict(zip(names, theta)))
    return ngal, wp


ngal0, wp0 = observables(theta0)

# --- exact Jacobians in one forward-mode sweep each.
jac_wp = jax.jacfwd(lambda t: observables(t)[1])(theta0)      # (n_rp, 5)
jac_ngal = jax.jacfwd(lambda t: observables(t)[0])(theta0)    # (5,)

# --- toy data covariance: 5% diagonal on wp, 3% on ngal.
inv_cov_wp = jnp.diag(1.0 / (0.05 * wp0) ** 2)
fisher = (jac_wp.T @ inv_cov_wp @ jac_wp +
          jnp.outer(jac_ngal, jac_ngal) / (0.03 * ngal0) ** 2)

cov = jnp.linalg.inv(fisher)
sigma = jnp.sqrt(jnp.diag(cov))
corr = cov / jnp.outer(sigma, sigma)

print("zheng07 Fisher forecast (wp + ngal, toy 5%/3% errors)")
for k, t, s in zip(names, theta0, sigma):
    print(f"  {k:>10s} = {float(t):7.3f} +/- {float(s):.3f}")
print("parameter correlation matrix:")
print(np.array2string(np.asarray(corr), precision=2, suppress_small=True))

# Sanity: the forecast must be positive-definite and finite.
assert np.all(np.isfinite(np.asarray(sigma))) and np.all(
    np.asarray(sigma) > 0)
print("OK")
