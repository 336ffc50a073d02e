"""Differentiable inversion of monotone scalar relations.

Used by the SHMR-based HOD models (models.leauthaud11,
models.zu_mandelbaum15) to evaluate the stellar mass at a given halo
mass when only the halo-mass-at-stellar-mass direction is closed-form;
exposed as a utility so user-supplied models (e.g. through
:class:`~.models.FunctionalHodModel`) can invert their own relations the
same way.

Two seeding strategies feed the Newton refinement:

* **interp** — piecewise-linear interpolation of ``fn`` sampled on a
  static grid.  One ``fn`` sweep over the grid plus a searchsorted/
  gather; the default when a grid is given.
* **bisect** — a fixed, unrolled bisection bracket shrink (``where``/
  arithmetic only); the default without a grid.

Both seeds land well inside the Newton basin; the refined root and its
parameter gradients (implicit function theorem through the final Newton
residuals — the seed's gradient contribution is zero for bisect and
negligible for interp) agree to float precision.
"""

from __future__ import annotations

from .backend import get_namespace


def monotone_inverse(fn, y, x_grid=None, dfn=None, newton_steps=3,
                     bracket=None, bisect_steps=15, seed="auto"):
    """Solve fn(x) = y for a strictly monotone, differentiable ``fn``.

    A seed estimate (see module docstring) is refined by a fixed number
    of Newton steps (an unrolled trip count, so the whole solve is
    forward- and reverse-differentiable — a ``while_loop`` would not
    be).  Gradients with respect to parameters closed over by ``fn``
    are exact to the Newton tolerance by the implicit function theorem:
    they flow through the final residual evaluations, not the seed.

    Parameters
    ----------
    fn : callable
        Strictly monotone increasing map ``x -> y`` (vectorized).
    y : array
        Query values.
    x_grid : array, optional
        Static, sorted abscissae covering the solution range for the
        interp seed; queries whose root lies outside clamp to the
        nearest grid end before refinement.  Required unless
        ``bracket`` is given.
    dfn : callable, optional
        Analytic derivative ``x -> dfn/dx``.  Default differentiates
        ``fn`` with jax (forward mode, per element).
    newton_steps : int, optional
        Number of unrolled Newton refinements.  Three converge a
        grid-resolution (or 15-step bisection) seed to float precision
        for smooth relations.
    bracket : (float, float), optional
        Static solution bounds for the bisect seed.  Defaults to the
        ends of ``x_grid`` (requiring a concrete, non-traced grid).
    bisect_steps : int, optional
        Unrolled bracket halvings for the bisect seed; 15 shrink a
        typical few-dex bracket below 1e-3 of its width, which three
        Newton steps converge past float64.
    seed : {'auto', 'interp', 'bisect'}, optional
        Seeding strategy.  'auto' uses interp when ``x_grid`` is given
        and bisect otherwise.

    Returns
    -------
    x : array
        The root, same shape as ``y``.
    """
    xp = get_namespace(y) if x_grid is None else get_namespace(y, x_grid)
    if seed == "auto":
        seed = "bisect" if x_grid is None else "interp"
    if seed == "interp":
        if x_grid is None:
            raise ValueError("seed='interp' requires x_grid.")
        y_grid = fn(x_grid)
        x = xp.interp(y, y_grid, x_grid)
    elif seed == "bisect":
        if bracket is None:
            if x_grid is None:
                raise ValueError(
                    "seed='bisect' requires bracket= or x_grid.")
            bracket = (float(x_grid[0]), float(x_grid[-1]))
        y = xp.asarray(y)
        lo = xp.full(y.shape, bracket[0], dtype=y.dtype)
        hi = xp.full(y.shape, bracket[1], dtype=y.dtype)
        for _ in range(bisect_steps):
            mid = 0.5 * (lo + hi)
            above = fn(mid) > y
            hi = xp.where(above, mid, hi)
            lo = xp.where(above, lo, mid)
        x = 0.5 * (lo + hi)
    else:
        raise ValueError(f"Unknown seed strategy: {seed!r}")
    if dfn is None:
        import jax

        def dfn(x_value):
            out, tangent = jax.jvp(fn, (x_value,),
                                   (xp.ones_like(x_value),))
            return tangent
    for _ in range(newton_steps):
        x = x - (fn(x) - y) / dfn(x)
    return x
