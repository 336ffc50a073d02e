"""Pair-counting kernels: the tabulation engine's compute core.

The reference farms one pair-count task per halo-bin pair to a
multiprocessing pool of native (Corrfunc/halotools-Cython) counters —
O(n_bins^2 / 2) ragged tasks (reference: tabcorr/tabcorr.py:846-922).  The
device design inverts this: ONE tiled sweep over all tracers carrying an
integer bin label per tracer, accumulating a dense
``counts[bin_1, bin_2, r_bin]`` histogram.  Fixed shapes, no ragged lists,
no task farm; the tile loop is a ``lax.fori_loop`` inside one jit per
i-chunk, and sharding the j-tracers over a device mesh (see parallel/)
turns the same kernel multi-device.  The per-tile histogram update runs
either as one-hot bilinear forms (matrix products) or as a flat
scatter-add; :func:`auto_strategy` picks between them and the host C++
counter (:mod:`tabcorr_tpu.native`).

Pair conventions match the reference's Corrfunc wrappers
(reference: tabcorr/corrfunc.py): *ordered* pairs (each unordered pair
counted twice, self-pairs excluded), periodic minimum-image separations,
natural estimator against the analytic random count.  Pair geometry is
float32: counts are exact given float32 separations, and only pairs within
one float32 ulp of a bin edge can classify differently from a float64
counter (measured ~1 unordered pair per ~10^6.5; far below the sampling
noise of any tabulation).

Accumulation precision: the device histogram is float32 but only holds
ONE i-chunk's partial counts; each dispatch folds into an on-device
compensated (TwoSum hi/lo) accumulator, transferred to the host ONCE at
the end.  A single histogram cell therefore only needs float32 integer
exactness within one i-chunk — bounded by CHUNK * (j tracers in the z
window) and in practice far below 2^24.  Each fold is a Knuth TwoSum
(the fold's rounding residual is captured exactly) followed by a
Fast2Sum renormalization of (hi, lo), so |lo| stays below one ulp of hi
at all times and the only per-fold rounding is in the ``lo + err``
update — a second-order term.  The worst-case cross-sweep error after n
folds is ~n * eps32 * ulp(hi) absolute, i.e. <~1e-8 relative at
production scale (1e9-1e10 pairs per cell over ~1e4-1e5 folds) — not
bit-exact integers, but two orders below the kernels' 1e-6 contract and
the sampling noise of any tabulation, with no device-to-host histogram
transfer per chunk.

Three binning geometries:

* ``rppi``  — projected radius bins with a |dz| < pi_max cut (for wp; the
  reference sums DDrppi counts over pi before the estimator, so only the
  cut matters: tabcorr/corrfunc.py:84-87).
* ``smu``   — (s, mu) bins with mu = |dz| / s.
* ``proj``  — projected radius bins over the full z column, optionally
  weighted (for delta sigma mass sums).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 1024
# i-chunks batched per device dispatch (the host-side sweep loop).
SWEEP_BLOCK = 16


def _pad_chunk(array, chunk, fill):
    """Pad to a power-of-two multiple of ``chunk``.

    Power-of-two length bucketing keeps the number of distinct compiled
    kernel shapes logarithmic in the data size (different mock realizations
    would otherwise each trigger a fresh XLA compile); padded entries carry
    label -1 / weight 0 and are masked out.
    """
    n = array.shape[0]
    n_chunks = max(-(-n // chunk), 1)
    target = chunk * (1 << (n_chunks - 1).bit_length())
    if target == n:
        return array
    pad_width = [(0, target - n)] + [(0, 0)] * (array.ndim - 1)
    if fill == "edge":
        return jnp.pad(array, pad_width, mode="edge")
    return jnp.pad(array, pad_width, constant_values=fill)


def _min_image(delta, period):
    return delta - period * jnp.round(delta / period)


def _bin_right(edges, values):
    """searchsorted(edges, values, 'right') - 1 via an unrolled compare
    sum: edge lists here are short (tens), and the unrolled broadcast
    compares stay on the VPU, where jnp.searchsorted's binary-search
    lowering costs gather-like shuffles per step on large operands."""
    idx = jnp.full(values.shape, -1, jnp.int32)
    for k in range(edges.shape[0]):
        idx += (values >= edges[k]).astype(jnp.int32)
    return idx


def _tile_geometry(p1, l1, i1, p2, l2, i2, w2, period, r_edges_sq, pi_max,
                   mu_edges, kind, n_r, n_mu, exclude_self):
    """Per-tile pair geometry: (sub_bin, valid, rp_sq), each (C, C)."""
    d = p1[:, None, :] - p2[None, :, :]
    d = _min_image(d, period)
    rp_sq = d[..., 0] ** 2 + d[..., 1] ** 2
    dz = jnp.abs(d[..., 2])

    valid = (l1[:, None] >= 0) & (l2[None, :] >= 0)
    if exclude_self:
        valid &= i1[:, None] != i2[None, :]

    if kind == "rppi":
        r_bin = _bin_right(r_edges_sq, rp_sq)
        valid &= (r_bin >= 0) & (r_bin < n_r) & (dz < pi_max)
        sub_bin = r_bin
    elif kind == "proj":
        r_bin = _bin_right(r_edges_sq, rp_sq)
        valid &= (r_bin >= 0) & (r_bin < n_r)
        sub_bin = r_bin
    else:  # smu
        s_sq = rp_sq + dz ** 2
        s_bin = _bin_right(r_edges_sq, s_sq)
        s = jnp.sqrt(s_sq)
        mu = jnp.where(s > 0, dz / jnp.maximum(s, 1e-30), 0.0)
        mu_bin = jnp.clip(_bin_right(mu_edges, mu), 0, n_mu - 1)
        valid &= (s_bin >= 0) & (s_bin < n_r) & (s > 0)
        sub_bin = s_bin * n_mu + mu_bin
    return sub_bin, valid, rp_sq


def _sweep_impl(hist, pos1, labels1, idx1, pos2, labels2, idx2,
                weights2, period, r_edges_sq, pi_max, mu_edges,
                j_start, j_count,
                kind, n_labels_1, n_labels_2, n_r, n_mu,
                exclude_self, strategy="matmul", pair_weight="unit",
                unit_counts=False):
    """Accumulate one i-chunk against all j-chunks into ``hist``.

    Dispatched once per i-chunk from the host so no single device kernel
    runs long (long-running monolithic kernels can trip accelerator
    watchdogs); the flat histogram is donated and updated in place.

    Two accumulation strategies:

    * ``'matmul'``: for each radial sub-bin c, the (label_1, label_2)
      histogram slab is the bilinear form ``onehot_1^T M_c onehot_2`` with
      ``M_c`` the masked (weighted) pair matrix — two matrix products per
      sub-bin, no scatter, at 2 * n_sub * min(n_l1, n_l2) FLOPs per pair.
    * ``'scatter'``: flat scatter-add of per-pair indices; fast on CPU
      where scatter is a gather-free memory update.
    """
    n_hist_r = n_r * (n_mu if kind == "smu" else 1)
    n_hist = n_labels_1 * n_labels_2 * n_hist_r
    n_channels = 2 if pair_weight == "unit+log_rp" else 1
    n2_chunks = pos2.shape[0] // CHUNK
    dtype = weights2.dtype

    def pair_weights(w2, rp_sq, valid):
        """Per-pair weight matrices, one per channel.

        'log_rp' (and the second 'unit+log_rp' channel) weights each
        pair by w2 * ln(rp) — the exact annulus-averaged delta-sigma
        estimator's Sum m ln rp per bin; rp_sq is floored to keep an
        exactly coincident pair finite (it can only land in the unused
        innermost cylinder bin anyway).  The dual mode shares one pair
        enumeration between both channels.
        """
        w = jnp.broadcast_to(w2[None, :], valid.shape)
        w = jnp.where(valid, w, jnp.zeros((), dtype))
        if pair_weight == "unit":
            return (w,)
        w_log = w * 0.5 * jnp.log(jnp.maximum(rp_sq, 1e-20))
        if pair_weight == "log_rp":
            return (w_log,)
        return (w, w_log)

    def tile_scatter(l1, l2, w2, sub_bin, valid, rp_sq, hist_inner):
        flat = ((l1[:, None] * n_labels_2 + l2[None, :]) * n_hist_r +
                sub_bin)
        flat = jnp.where(valid, flat, n_channels * n_hist)
        for ch, w in enumerate(pair_weights(w2, rp_sq, valid)):
            offset = jnp.where(valid, ch * n_hist, 0)
            hist_inner = hist_inner.at[
                (flat + offset).ravel()].add(w.ravel())
        return hist_inner

    def tile_matmul(l1, l2, w2, sub_bin, valid, rp_sq, hist_inner):
        # One-hot label matrices; invalid labels (< 0) one-hot to zero.
        oh1 = (l1[:, None] ==
               jnp.arange(n_labels_1)[None, :]).astype(dtype)
        oh2 = (l2[:, None] ==
               jnp.arange(n_labels_2)[None, :]).astype(dtype)
        wmats = pair_weights(w2, rp_sq, valid)

        slab = hist_inner[:n_channels * n_hist].reshape(
            n_channels, n_labels_1, n_labels_2, n_hist_r)

        def bilinear(m):
            # Second product: HIGHEST always — its input carries partial
            # counts that exceed the 8-bit (bf16) or 10-bit (TF32)
            # significand of a reduced-precision pass.  First product:
            # with unit weights every operand entry is exactly 0 or 1,
            # which bf16 and TF32 represent exactly, and the float32
            # accumulator sums integers below 2^24 (at most CHUNK per
            # tile), which float32 adds exactly — so DEFAULT precision
            # (TF32 on a GPU) counts EXACTLY at a fraction of the cost.
            # Weighted sweeps (delta-sigma masses) keep HIGHEST for
            # float32-grade weights.
            hi = jax.lax.Precision.HIGHEST
            first = jax.lax.Precision.DEFAULT if unit_counts else hi
            if n_labels_2 <= n_labels_1:
                t = jnp.dot(m, oh2, preferred_element_type=dtype,
                            precision=first)
                return jnp.dot(oh1.T, t, preferred_element_type=dtype,
                               precision=hi)
            t = jnp.dot(oh1.T, m, preferred_element_type=dtype,
                        precision=first)
            return jnp.dot(t, oh2, preferred_element_type=dtype,
                           precision=hi)

        def c_body(c, slab_inner):
            in_bin = sub_bin == c
            h = jnp.stack([
                bilinear(jnp.where(in_bin, w, jnp.zeros((), dtype)))
                for w in wmats])
            return jax.lax.dynamic_update_index_in_dim(
                slab_inner,
                jax.lax.dynamic_index_in_dim(
                    slab_inner, c, axis=3, keepdims=False) + h,
                c, axis=3)

        slab = jax.lax.fori_loop(0, n_hist_r, c_body, slab)
        return hist_inner.at[:n_channels * n_hist].set(slab.reshape(-1))

    tile_fn = tile_matmul if strategy == "matmul" else tile_scatter

    def j_body(t, hist_inner):
        # Circular window over z-sorted chunks: only chunks within the
        # line-of-sight cut of this i-chunk are visited.
        j_chunk = ((j_start + t) % n2_chunks).astype(jnp.int32)
        p2 = jax.lax.dynamic_slice(pos2, (j_chunk * CHUNK, jnp.int32(0)),
                                   (CHUNK, 3))
        l2 = jax.lax.dynamic_slice(labels2, (j_chunk * CHUNK,),
                                   (CHUNK,))
        i2 = jax.lax.dynamic_slice(idx2, (j_chunk * CHUNK,), (CHUNK,))
        w2 = jax.lax.dynamic_slice(weights2, (j_chunk * CHUNK,),
                                   (CHUNK,))
        sub_bin, valid, rp_sq = _tile_geometry(
            pos1, labels1, idx1, p2, l2, i2, w2, period, r_edges_sq,
            pi_max, mu_edges, kind, n_r, n_mu, exclude_self)
        return tile_fn(labels1, l2, w2, sub_bin, valid, rp_sq, hist_inner)

    return jax.lax.fori_loop(0, j_count, j_body, hist)


def _twosum_fold_impl(hi, lo, x):
    """Fold ``x`` into the compensated (hi, lo) accumulator.

    Knuth TwoSum: ``s + err == hi + x`` exactly in float arithmetic, so
    the only rounding is in ``lo + err``; the trailing Fast2Sum
    renormalization (valid because |lo'| <= |s| here) folds the residual
    back into hi so |lo| never exceeds one ulp of hi — the accumulated
    error stays second order (~n * eps32 * ulp(hi); see the module
    docstring) instead of growing with the residual magnitude.
    """
    s = hi + x
    bp = s - hi
    err = (hi - (s - bp)) + (x - bp)
    lo = lo + err
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo


_twosum_fold = partial(jax.jit, donate_argnums=(0, 1))(_twosum_fold_impl)


def _sweep_block_impl(acc_hi, acc_lo, block, pos1, labels1,
                      idx1, pos2, labels2, idx2, weights2, period,
                      r_edges_sq, pi_max, mu_edges, j_starts, j_counts,
                      kind, n_labels_1, n_labels_2, n_r, n_mu,
                      exclude_self, n_block, strategy="matmul",
                      pair_weight="unit", unit_counts=False):
    """Sweep ``n_block`` consecutive i-chunks in ONE dispatch, folding
    EACH chunk's float32 partial into the TwoSum accumulator.

    Everything — chunk slicing, the fresh per-chunk histogram, the
    window bounds and the compensated folds — lives inside this single
    jitted call, so the host loop dispatches once per block instead of
    once per device op.
    Folding per CHUNK (not per block) preserves the module invariant
    that a raw float32 histogram only ever holds one i-chunk's counts.
    """
    def k_body(k, carry):
        hi, lo = carry
        k = k.astype(jnp.int32)
        chunk = block.astype(jnp.int32) * n_block + k
        p1 = jax.lax.dynamic_slice(pos1, (chunk * CHUNK, jnp.int32(0)),
                                   (CHUNK, 3))
        l1 = jax.lax.dynamic_slice(labels1, (chunk * CHUNK,), (CHUNK,))
        i1 = jax.lax.dynamic_slice(idx1, (chunk * CHUNK,), (CHUNK,))
        hist = _sweep_impl(
            jnp.zeros(hi.shape, dtype=hi.dtype), p1, l1, i1, pos2,
            labels2, idx2, weights2,
            period, r_edges_sq, pi_max, mu_edges, j_starts[chunk],
            j_counts[chunk], kind, n_labels_1, n_labels_2, n_r, n_mu,
            exclude_self, strategy=strategy, pair_weight=pair_weight,
            unit_counts=unit_counts)
        return _twosum_fold_impl(hi, lo, hist)

    return jax.lax.fori_loop(0, n_block, k_body, (acc_hi, acc_lo))


_sweep_block = partial(jax.jit, static_argnames=(
    "kind", "n_labels_1", "n_labels_2", "n_r", "n_mu",
    "exclude_self", "n_block", "strategy", "pair_weight", "unit_counts"),
    donate_argnums=(0, 1))(_sweep_block_impl)


@partial(jax.jit, static_argnames=("mesh", "kind", "n_labels_1",
                                   "n_labels_2", "n_r", "n_mu",
                                   "exclude_self", "n_block", "strategy",
                                   "pair_weight", "unit_counts"),
         donate_argnums=(0, 1))
def _sweep_block_sharded(acc_hi, acc_lo, block, pos1, labels1, idx1,
                         pos2, labels2, idx2, weights2, period,
                         r_edges_sq, pi_max, mu_edges, j_starts, j_counts,
                         mesh, kind, n_labels_1, n_labels_2, n_r, n_mu,
                         exclude_self, n_block, strategy="matmul",
                         pair_weight="unit", unit_counts=False):
    """Mesh-sharded block sweep: j-tracers split across devices, with the
    same SWEEP_BLOCK batching and in-call TwoSum folds as the single-chip
    path (:func:`_sweep_block_impl`).

    Each device sweeps ``n_block`` i-chunks against ITS shard of the
    z-sorted j-tracers, visiting only its local z-window per i-chunk
    (``j_starts``/``j_counts`` rows are per-device hulls from
    :func:`_chunk_windows`), folding every chunk's float32 partial into a
    device-local compensated accumulator; ONE psum per (hi, lo) pair
    merges the block across the interconnect, and the merged partials
    fold into the global accumulator inside the same jit — per-block
    dispatch count identical to the single-chip path (the multi-chip
    analog of the reference's bin-pair task farm,
    reference: tabcorr/tabcorr.py:880-901).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_hist = acc_hi.shape[0]

    def local(p2, l2, i2, w2, j_s, j_c):
        zero = jnp.zeros(n_hist, dtype=w2.dtype)
        hi0 = jax.lax.pcast(zero, (axis,), to="varying")
        lo0 = jax.lax.pcast(zero, (axis,), to="varying")

        def k_body(k, carry):
            hi, lo = carry
            chunk = block.astype(jnp.int32) * n_block + k.astype(jnp.int32)
            p1 = jax.lax.dynamic_slice(
                pos1, (chunk * CHUNK, jnp.int32(0)), (CHUNK, 3))
            l1 = jax.lax.dynamic_slice(labels1, (chunk * CHUNK,), (CHUNK,))
            i1 = jax.lax.dynamic_slice(idx1, (chunk * CHUNK,), (CHUNK,))
            # Fresh per-chunk histogram, marked device-varying for the
            # shard_map VMA checker (the sweep mixes it with sharded
            # data inside a fori_loop carry).
            hist0 = jax.lax.pcast(jnp.zeros(n_hist, dtype=hi.dtype),
                                  (axis,), to="varying")
            hist = _sweep_impl(
                hist0, p1, l1, i1, p2, l2,
                i2, w2, period, r_edges_sq, pi_max, mu_edges,
                j_s[0, chunk], j_c[0, chunk], kind, n_labels_1,
                n_labels_2, n_r, n_mu, exclude_self, strategy=strategy,
                pair_weight=pair_weight, unit_counts=unit_counts)
            return _twosum_fold_impl(hi, lo, hist)

        hi, lo = jax.lax.fori_loop(0, n_block, k_body, (hi0, lo0))
        return jax.lax.psum(hi, axis), jax.lax.psum(lo, axis)

    hi_sum, lo_sum = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  P(axis, None), P(axis, None)),
        out_specs=(P(), P()))(pos2, labels2, idx2, weights2,
                              j_starts, j_counts)
    acc_hi, acc_lo = _twosum_fold_impl(acc_hi, acc_lo, hi_sum)
    return _twosum_fold_impl(acc_hi, acc_lo, lo_sum)


def _chunk_windows(z1, z2, z_cut, period_z, n_shards=None):
    """Circular j-chunk visit window per i-chunk, for z-sorted tracers.

    Each chunk covers a contiguous z interval; a j-chunk can contain pairs
    within ``z_cut`` of an i-chunk only if the periodic gap between their
    intervals is at most ``z_cut``.  With ``n_shards=None`` the qualifying
    set is a contiguous circular run, returned as a list of
    (start_chunk, count).  With ``n_shards`` set (the mesh-sharded sweep:
    j-chunks split blockwise over devices), returns two
    (n_shards, n1_chunks) int arrays (local_start, local_count) — the
    non-circular HULL of each device's qualifying local chunks.  A hull
    may include a few non-qualifying chunks when the global circular run
    wraps through a device's range (boundary i-chunks only); that costs
    a little extra work, never correctness — the pair geometry re-checks
    every candidate pair.
    """
    n1c = len(z1) // CHUNK
    n2c = len(z2) // CHUNK
    z1c = z1.reshape(n1c, CHUNK)
    z2c = z2.reshape(n2c, CHUNK)
    a1, b1 = z1c.min(axis=1), z1c.max(axis=1)
    a2, b2 = z2c.min(axis=1), z2c.max(axis=1)

    margin = 1e-3 + 1e-6 * period_z  # float32 edge safety
    if n_shards is not None:
        cps = n2c // n_shards
        starts = np.zeros((n_shards, n1c), dtype=np.int32)
        counts = np.zeros((n_shards, n1c), dtype=np.int32)
    windows = []
    for i in range(n1c):
        gaps = []
        for k in (-period_z, 0.0, period_z):
            gaps.append(np.maximum(
                np.maximum(a2 + k - b1[i], a1[i] - (b2 + k)), 0.0))
        gap = np.minimum.reduce(gaps)
        mask = gap <= z_cut + margin
        if n_shards is not None:
            sub = mask.reshape(n_shards, cps)
            has_any = sub.any(axis=1)
            first = np.argmax(sub, axis=1)
            last = cps - 1 - np.argmax(sub[:, ::-1], axis=1)
            starts[:, i] = np.where(has_any, first, 0)
            counts[:, i] = np.where(has_any, last - first + 1, 0)
            continue
        if mask.all():
            windows.append((0, n2c))
            continue
        run_starts = np.flatnonzero(mask & ~np.roll(mask, 1))
        if len(run_starts) != 1:
            # Non-contiguous qualifying set (shouldn't happen for sorted
            # chunks): fall back to the full sweep.
            windows.append((0, n2c))
        else:
            windows.append((int(run_starts[0]), int(mask.sum())))
    if n_shards is not None:
        return starts, counts
    return windows


def auto_strategy(kind, mu_edges, mesh=None):
    """The histogram strategy ``labeled_pair_count(strategy='auto')`` uses.

    The host C++ counter wherever it can serve the call (no mesh,
    uniform mu bins, a g++ build): at the published wp geometry (120
    labels, 14 rp bins, 2e5 tracers in a 1050 box) it took 1.4 s on the
    16 cores beside an NVIDIA H100, against 5.3 s for the GPU matmul
    sweep and 25.5 s for the GPU scatter sweep (chip_smoke.py phase f).
    Otherwise the device sweep: one-hot matrix products on a GPU, the
    flat scatter-add on a CPU.
    """
    if mesh is None and _native_eligible(kind, mu_edges):
        return "native"
    return "matmul" if jax.default_backend() == "gpu" else "scatter"


def _native_eligible(kind, mu_edges):
    """True when the C++ counter can serve this call exactly.

    The native backend requires uniform [0, 1] mu bins ('smu' only) and
    a successful build of the shared library (g++ present).
    """
    if kind == "smu":
        mu = np.asarray(mu_edges, dtype=np.float64)
        if not np.allclose(mu, np.linspace(0, 1, len(mu))):
            return False
    from .. import native as _native
    return _native.native_available()


def labeled_pair_count(pos1, labels1, n_labels_1, pos2=None, labels2=None,
                       n_labels_2=None, weights2=None, period=1.0,
                       kind="rppi", r_edges=None, pi_max=None,
                       mu_edges=None, progress=False, mesh=None,
                       strategy="auto", sort=True, pair_weight="unit"):
    """Count pairs between labeled tracer sets (host-facing wrapper).

    Parameters
    ----------
    pos1, pos2 : (N, 3) arrays.  ``pos2=None`` means auto-correlation
        (self-pairs excluded, each unordered pair counted twice).
    labels1, labels2 : (N,) int bin labels; negative labels are ignored.
    weights2 : (N2,) optional weights (e.g. particle masses).
    period : float or (3,) periodic box.
    kind : 'rppi' | 'smu' | 'proj'.
    r_edges : radial (rp or s) bin edges.
    pi_max : line-of-sight cut for 'rppi'.
    mu_edges : mu bin edges for 'smu'.
    mesh : jax.sharding.Mesh, optional
        If given, the second tracer set is sharded over the mesh's first
        axis and partial histograms are psum-merged over the interconnect.
    strategy : str, optional
        Histogram accumulation: 'matmul' (one-hot bilinear forms),
        'scatter' (flat scatter-add), 'native' (the C++ cell-list
        counter, tabcorr_tpu.native), or 'auto' (:func:`auto_strategy`).
    sort : bool, optional
        Sort tracers along z so each i-chunk only visits the circular
        window of j-chunks within the line-of-sight cut (pi_max for
        'rppi', s_max for 'smu') — the device analog of a cell list along
        the z axis.  No effect on results.  Default is True.
    pair_weight : str, optional
        'unit' (default) accumulates weights2 per pair; 'log_rp'
        accumulates weights2 * ln(rp) per pair (for the exact
        annulus-averaged delta-sigma estimator); 'unit+log_rp' produces
        BOTH channels from a single pair enumeration (leading axis 2 on
        the result) — the delta-sigma tabulation needs both and the
        enumeration dominates its cost.

    Returns
    -------
    counts : (n_labels_1, n_labels_2, n_r[, n_mu]) float64 array, with
        a leading channel axis of size 2 for 'unit+log_rp'.
    """
    if strategy == "auto":
        strategy = auto_strategy(kind, mu_edges, mesh)
    if strategy == "native":
        if mesh is not None:
            raise ValueError(
                "strategy='native' runs on the host and cannot shard "
                "over a mesh; use 'matmul' or 'scatter' with mesh=.")
        from .. import native as _native
        return np.asarray(_native.labeled_pair_count(
            np.asarray(pos1), np.asarray(labels1), n_labels_1,
            pos2=None if pos2 is None else np.asarray(pos2),
            labels2=None if labels2 is None else np.asarray(labels2),
            n_labels_2=n_labels_2,
            weights2=None if weights2 is None else np.asarray(weights2),
            period=period, kind=kind, r_edges=r_edges, pi_max=pi_max,
            mu_edges=mu_edges, pair_weight=pair_weight))
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    r_edges = np.asarray(r_edges, dtype=np.float64)
    n_r = len(r_edges) - 1
    if kind == "smu":
        mu_edges = np.asarray(mu_edges, dtype=np.float64)
        n_mu = len(mu_edges) - 1
    else:
        mu_edges = np.zeros(2)
        n_mu = 1

    # z-window cut for the sorted sweep (None disables windowing).
    if kind == "rppi":
        z_cut = pi_max
    elif kind == "smu":
        z_cut = r_edges[-1]
    else:
        z_cut = None
    use_sort = (sort and z_cut is not None and 2 * z_cut < period[2])

    auto = pos2 is None
    pos1 = np.asarray(pos1, dtype=np.float32)
    labels1 = np.asarray(labels1, dtype=np.int32)
    if not auto:
        pos2 = np.asarray(pos2, dtype=np.float32)
        labels2 = (np.zeros(len(pos2), dtype=np.int32)
                   if labels2 is None else
                   np.asarray(labels2, dtype=np.int32))
        n_labels_2 = n_labels_2 or int(labels2.max()) + 1
    # Weights are normalized to order unity on device and rescaled in
    # float64 on the host: accumulating raw large weights (e.g. particle
    # masses ~1e9) in the float32 per-chunk partials rounds each add to
    # the partial's ulp, a systematic ~1e-4 bias.
    weight_scale = 1.0
    # The single-pass count-matmul shortcut only applies when EVERY
    # channel's pair-weight matrix is exactly 0/1: a log_rp channel
    # carries w * ln(rp) values that bf16 would round.
    unit_counts = weights2 is None and pair_weight == "unit"
    if weights2 is not None:
        weights2 = np.asarray(weights2, dtype=np.float64)
        if weights2.ndim == 0:
            weights2 = np.full(len(pos2) if not auto else len(pos1),
                               weights2, dtype=np.float64)
        weight_scale = float(np.max(np.abs(weights2))) or 1.0
        weights2 = (weights2 / weight_scale).astype(np.float32)

    if use_sort:
        order1 = np.argsort(pos1[:, 2], kind="stable")
        pos1, labels1 = pos1[order1], labels1[order1]
        if not auto:
            order2 = np.argsort(pos2[:, 2], kind="stable")
            pos2, labels2 = pos2[order2], labels2[order2]
            if weights2 is not None:
                weights2 = weights2[order2]
        elif weights2 is not None:
            weights2 = weights2[order1]

    pos1 = jnp.asarray(pos1)
    labels1 = jnp.asarray(labels1)
    idx1 = jnp.arange(pos1.shape[0], dtype=jnp.int32)
    if auto:
        pos2, labels2, idx2 = pos1, labels1, idx1
        n_labels_2 = n_labels_1
    else:
        pos2 = jnp.asarray(pos2)
        labels2 = jnp.asarray(labels2)
        idx2 = -jnp.ones(pos2.shape[0], dtype=jnp.int32)

    if weights2 is None:
        weights2 = jnp.ones(pos2.shape[0], dtype=jnp.float32)
    else:
        weights2 = jnp.asarray(weights2)

    n_shards = 1 if mesh is None else int(np.prod(
        [mesh.shape[name] for name in mesh.axis_names[:1]]))
    # Edge-replicated position padding keeps the z-sorted order monotone
    # (padded rows carry label -1 and never count).
    pos1 = _pad_chunk(pos1, CHUNK, "edge")
    labels1 = _pad_chunk(labels1, CHUNK, -1)
    idx1 = _pad_chunk(idx1, CHUNK, -2)
    pos2 = _pad_chunk(pos2, CHUNK * n_shards, "edge")
    labels2 = _pad_chunk(labels2, CHUNK * n_shards, -1)
    idx2 = _pad_chunk(idx2, CHUNK * n_shards, -3)
    weights2 = _pad_chunk(weights2, CHUNK * n_shards, 0.0)

    n2_chunks = pos2.shape[0] // CHUNK
    n1_chunks = pos1.shape[0] // CHUNK
    if mesh is None:
        if use_sort:
            windows = _chunk_windows(
                np.asarray(pos1[:, 2]), np.asarray(pos2[:, 2]), z_cut,
                period[2])
        else:
            windows = [(0, n2_chunks)] * n1_chunks
    else:
        if use_sort:
            shard_starts, shard_counts = _chunk_windows(
                np.asarray(pos1[:, 2]), np.asarray(pos2[:, 2]), z_cut,
                period[2], n_shards=n_shards)
        else:
            cps = n2_chunks // n_shards
            shard_starts = np.zeros((n_shards, n1_chunks), np.int32)
            shard_counts = np.full((n_shards, n1_chunks), cps, np.int32)

    period_dev = jnp.asarray(period, dtype=jnp.float32)
    edges_dev = jnp.asarray(r_edges**2, dtype=jnp.float32)
    pi_max_dev = jnp.float32(pi_max if pi_max is not None else 0.0)
    mu_dev = jnp.asarray(mu_edges, dtype=jnp.float32)

    n_hist_r = n_r * (n_mu if kind == "smu" else 1)
    n_channels = 2 if pair_weight == "unit+log_rp" else 1
    n_hist = n_channels * n_labels_1 * n_labels_2 * n_hist_r

    # One dispatch per SWEEP_BLOCK of i-chunks: bounded kernel runtimes
    # and natural host-side progress points; partials fold into the
    # on-device TwoSum (hi, lo) accumulator — exact (see module
    # docstring) with no per-chunk device-to-host transfer.
    acc_hi = jnp.zeros(n_hist + 1, dtype=weights2.dtype)
    acc_lo = jnp.zeros(n_hist + 1, dtype=weights2.dtype)
    # Batch i-chunks per dispatch and keep the WHOLE loop body in one
    # jit call per block (see _sweep_block_impl / _sweep_block_sharded;
    # both paths share the SWEEP_BLOCK batching, z-window sorting and
    # in-call TwoSum folds).  The final short block pads with
    # j_count = 0 chunks (no-ops).
    n_blocks = -(-n1_chunks // SWEEP_BLOCK)
    pad_chunks = n_blocks * SWEEP_BLOCK - n1_chunks
    if mesh is None:
        j_starts = jnp.asarray(np.array(
            [w[0] for w in windows] + [0] * pad_chunks, dtype=np.int32))
        j_counts = jnp.asarray(np.array(
            [w[1] for w in windows] + [0] * pad_chunks, dtype=np.int32))
    else:
        j_starts = jnp.asarray(np.pad(shard_starts,
                                      ((0, 0), (0, pad_chunks))))
        j_counts = jnp.asarray(np.pad(shard_counts,
                                      ((0, 0), (0, pad_chunks))))
    pos1 = _pad_chunk(pos1, SWEEP_BLOCK * CHUNK, "edge")
    labels1 = _pad_chunk(labels1, SWEEP_BLOCK * CHUNK, -1)
    idx1 = _pad_chunk(idx1, SWEEP_BLOCK * CHUNK, -2)
    blocks = range(n_blocks)
    if progress:
        import tqdm
        blocks = tqdm.tqdm(blocks, smoothing=0, desc="pair counting")
    for b in blocks:
        if mesh is None:
            acc_hi, acc_lo = _sweep_block(
                acc_hi, acc_lo, b, pos1, labels1, idx1,
                pos2, labels2, idx2, weights2, period_dev, edges_dev,
                pi_max_dev, mu_dev, j_starts, j_counts,
                kind, int(n_labels_1), int(n_labels_2), n_r, n_mu,
                exclude_self=auto, n_block=SWEEP_BLOCK,
                strategy=strategy, pair_weight=pair_weight,
                unit_counts=unit_counts)
        else:
            acc_hi, acc_lo = _sweep_block_sharded(
                acc_hi, acc_lo, b, pos1, labels1, idx1,
                pos2, labels2, idx2, weights2, period_dev, edges_dev,
                pi_max_dev, mu_dev, j_starts, j_counts, mesh=mesh,
                kind=kind, n_labels_1=int(n_labels_1),
                n_labels_2=int(n_labels_2), n_r=n_r, n_mu=n_mu,
                exclude_self=auto, n_block=SWEEP_BLOCK,
                strategy=strategy, pair_weight=pair_weight,
                unit_counts=unit_counts)

    host_hist = (np.asarray(acc_hi, dtype=np.float64) +
                 np.asarray(acc_lo, dtype=np.float64))
    counts = host_hist[:n_hist] * weight_scale
    shape = (n_labels_1, n_labels_2, n_r) if kind != "smu" else \
        (n_labels_1, n_labels_2, n_r, n_mu)
    if n_channels == 2:
        return counts.reshape((2,) + shape)
    return counts.reshape(shape)


# ----------------------------------------------------------------------
# halotools-signature statistics (reference: tabcorr/corrfunc.py:6-175)
# ----------------------------------------------------------------------
def _check_auto_cross(do_auto, do_cross):
    if do_auto == do_cross:
        raise ValueError("'do_auto' and 'do_cross' cannot both be True or "
                         "False.")


def wp(sample1, rp_bins, pi_max, sample2=None, period=None, do_auto=True,
       do_cross=False):
    """Projected correlation function wp(rp), natural estimator.

    Drop-in for the reference's Corrfunc wrapper (tabcorr/corrfunc.py:6-87):
    counts ordered pairs with |dz| < pi_max against the analytic random
    expectation, wp = (DD / RR - 1) * 2 * pi_max.
    """
    _check_auto_cross(do_auto, do_cross)
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    rp_bins = np.asarray(rp_bins, dtype=np.float64)

    if do_auto:
        counts = labeled_pair_count(
            sample1, np.zeros(len(sample1), dtype=np.int32), 1,
            period=period, kind="rppi", r_edges=rp_bins, pi_max=pi_max)
        n_pairs = len(sample1) * len(sample1)
    else:
        counts = labeled_pair_count(
            sample1, np.zeros(len(sample1), dtype=np.int32), 1,
            pos2=sample2, period=period, kind="rppi", r_edges=rp_bins,
            pi_max=pi_max)
        n_pairs = len(sample1) * len(sample2)

    n_exp = (n_pairs / np.prod(period) * np.pi * np.diff(rp_bins**2) *
             2 * pi_max)
    return (counts[0, 0] / n_exp - 1) * 2 * pi_max


def s_mu_tpcf(sample1, s_bins, mu_bins, sample2=None, period=None,
              do_auto=True, do_cross=False):
    """Redshift-space xi(s, mu), mu = |dz|/s on [0, 1].

    Drop-in for the reference's Corrfunc wrapper
    (tabcorr/corrfunc.py:90-175); requires uniform mu bins on [0, 1].
    """
    _check_auto_cross(do_auto, do_cross)
    mu_bins = np.asarray(mu_bins, dtype=np.float64)
    if not np.allclose(mu_bins, np.linspace(0, 1, len(mu_bins))):
        raise ValueError("Bins in mu must be uniform from 0 to 1.")
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    s_bins = np.asarray(s_bins, dtype=np.float64)

    if do_auto:
        counts = labeled_pair_count(
            sample1, np.zeros(len(sample1), dtype=np.int32), 1,
            period=period, kind="smu", r_edges=s_bins, mu_edges=mu_bins)
        n_pairs = len(sample1) * len(sample1)
    else:
        counts = labeled_pair_count(
            sample1, np.zeros(len(sample1), dtype=np.int32), 1,
            pos2=sample2, period=period, kind="smu", r_edges=s_bins,
            mu_edges=mu_bins)
        n_pairs = len(sample1) * len(sample2)

    n_exp = (n_pairs / np.prod(period) * 4 * np.pi / 3 *
             np.diff(s_bins**3) / (len(mu_bins) - 1))
    return counts[0, 0] / n_exp[:, None] - 1


def tpcf(sample1, r_bins, sample2=None, period=None, do_auto=True,
         do_cross=False):
    """Real-space two-point correlation function xi(r), natural estimator.

    3-D isotropic counterpart of :func:`wp` / :func:`s_mu_tpcf`
    (halotools ``mock_observables.tpcf`` signature subset; the reference
    accepts any halotools-signature callable as its ``tpcf`` argument,
    tabcorr/tabcorr.py:41-44).  Counts pairs in spherical shells against
    the analytic periodic-box random expectation, xi = DD / RR - 1.
    Implemented as an (s, mu) sweep with a single mu bin, so it shares
    the device kernels (and the native C++ counter) with
    :func:`s_mu_tpcf`.
    """
    xi = s_mu_tpcf(sample1, np.asarray(r_bins, dtype=np.float64),
                   np.array([0.0, 1.0]), sample2=sample2, period=period,
                   do_auto=do_auto, do_cross=do_cross)
    return xi[:, 0]


def delta_sigma_from_mass_profiles(rp_bins, mass_in, mass_annulus,
                                   log_mass_annulus, n_gal):
    """Exact annulus-averaged delta-sigma from per-annulus mass sums.

    With Sigma_bar(<r) = M(<r) / (pi r^2 N) and Sigma(r) r dr = dM/(2 pi N),
    the area-weighted mean of delta-sigma(r) = Sigma_bar(<r) - Sigma(r)
    over the annulus [r1, r2] has the closed form

        <ds>_i = 2 / (pi (r2^2 - r1^2) N) *
                 [ ln(r2/r1) M(<r1) + S0_i ln(r2) - SL_i - S0_i / 2 ]

    where S0_i is the pair mass in the annulus and SL_i = Sum m ln(rp)
    over pairs in the annulus — every term is an exact pair-count sum, no
    midpoint evaluation or profile interpolation.  Leading axes of the
    mass arrays broadcast (e.g. one profile per halo bin).
    """
    r1, r2 = rp_bins[:-1], rp_bins[1:]
    bracket = (np.log(r2 / r1) * mass_in + mass_annulus * np.log(r2) -
               log_mass_annulus - 0.5 * mass_annulus)
    return 2.0 * bracket / (np.pi * (r2**2 - r1**2) * n_gal)


def mean_delta_sigma(galaxies, particles, particle_masses, rp_bins,
                     period=None, estimator="annulus_mean"):
    """Mean excess surface density delta-sigma(rp) [h Msun / Mpc^2].

    Galaxy-particle cross pair mass sums in projected annuli (full
    periodic z column).  Functional replacement for halotools'
    ``mean_delta_sigma`` (used by the reference at
    scripts/tabulate_snapshot.py:235-237).

    Estimators:

    * ``'annulus_mean'`` (default): the exact area-weighted average of
      delta-sigma(r) over each annulus, evaluated in closed form from
      pair-count sums (see :func:`delta_sigma_from_mass_profiles`) —
      no midpoint choice, no interpolation.
    * ``'midpoint'``: sigma_bar(< r_mid) - sigma(annulus) at the
      geometric bin center r_mid = sqrt(r1 r2).

    Both agree to O((dr/r)^2) for smooth profiles.
    """
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    rp_bins = np.asarray(rp_bins, dtype=np.float64)
    particle_masses = np.asarray(particle_masses, dtype=np.float64)
    if particle_masses.ndim == 0:
        particle_masses = np.full(len(particles), particle_masses)
    n_gal = len(galaxies)
    labels = np.zeros(n_gal, dtype=np.int32)

    if estimator == "annulus_mean":
        edges = np.concatenate([[0.0], rp_bins])
        # Both weight channels from ONE pair enumeration — the
        # enumeration dominates delta-sigma cost.
        mass, log_mass = labeled_pair_count(
            galaxies, labels, 1, pos2=particles,
            weights2=particle_masses, period=period, kind="proj",
            r_edges=edges, pair_weight="unit+log_rp")[:, 0, 0]
        mass_in = np.cumsum(mass)[:-1]  # M(< r1) per annulus
        return delta_sigma_from_mass_profiles(
            rp_bins, mass_in, mass[1:], log_mass[1:], n_gal)

    if estimator != "midpoint":
        raise ValueError(f"Unknown estimator '{estimator}'.")

    rp_mids = np.sqrt(rp_bins[:-1] * rp_bins[1:])
    # One histogram over the combined edge list [0, mids+edges deduped]:
    # cumulative sums then give cylinder masses at every radius.  Edges
    # are deduplicated (a geometric mid can coincide bitwise with a bin
    # edge) and cylinder masses looked up by searchsorted index, never by
    # float dict key.
    all_edges = np.unique(np.concatenate([[0.0], rp_bins, rp_mids]))
    counts = labeled_pair_count(
        galaxies, labels, 1, pos2=particles, weights2=particle_masses,
        period=period, kind="proj", r_edges=all_edges)[0, 0]
    cum_mass = np.concatenate([[0.0], np.cumsum(counts)])

    def mass_at(r):
        return cum_mass[np.searchsorted(all_edges, r)]

    sigma_bar = mass_at(rp_mids) / (np.pi * rp_mids**2 * n_gal)
    annulus_mass = mass_at(rp_bins[1:]) - mass_at(rp_bins[:-1])
    sigma = annulus_mass / (np.pi * np.diff(rp_bins**2) * n_gal)
    return sigma_bar - sigma
