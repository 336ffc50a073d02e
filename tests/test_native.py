"""Native (C++ cell-list) pair counter vs the device kernels."""

import numpy as np
import pytest

from tabcorr_tpu import native
from tabcorr_tpu.ops import paircount

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="no native toolchain")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    L = 60.0
    pos = rng.uniform(0, L, (900, 3))
    labels = rng.integers(0, 3, 900).astype(np.int32)
    return L, pos, labels


def test_native_rppi_matches_jax(data):
    L, pos, labels = data
    rp_bins = np.logspace(-0.5, 1.1, 6)
    want = paircount.labeled_pair_count(
        pos, labels, 3, period=L, kind="rppi", r_edges=rp_bins, pi_max=8.0)
    got = native.labeled_pair_count(
        pos, labels, 3, period=L, kind="rppi", r_edges=rp_bins, pi_max=8.0)
    np.testing.assert_array_equal(got, want)


def test_native_smu_matches_jax(data):
    L, pos, labels = data
    s_bins = np.logspace(-0.5, 1.1, 5)
    mu_bins = np.linspace(0, 1, 6)
    want = paircount.labeled_pair_count(
        pos, labels, 3, period=L, kind="smu", r_edges=s_bins,
        mu_edges=mu_bins)
    got = native.labeled_pair_count(
        pos, labels, 3, period=L, kind="smu", r_edges=s_bins,
        mu_edges=mu_bins)
    np.testing.assert_array_equal(got, want)


def test_native_proj_weighted_matches_jax(data):
    L, pos, labels = data
    rng = np.random.default_rng(5)
    ptcl = rng.uniform(0, L, (2000, 3))
    weights = rng.uniform(0.5, 2.0, 2000)
    rp_bins = np.logspace(-0.5, 1.0, 5)
    want = paircount.labeled_pair_count(
        pos, labels, 3, pos2=ptcl, weights2=weights, period=L,
        kind="proj", r_edges=rp_bins)
    got = native.labeled_pair_count(
        pos, labels, 3, pos2=ptcl, weights2=weights, period=L,
        kind="proj", r_edges=rp_bins)
    # The device kernel accumulates weights in float32, the native one in
    # float64: only approximate agreement is expected.
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_native_cross_labels(data):
    L, pos, labels = data
    rng = np.random.default_rng(6)
    pos2 = rng.uniform(0, L, (500, 3))
    labels2 = rng.integers(0, 2, 500).astype(np.int32)
    rp_bins = np.logspace(-0.5, 1.0, 4)
    want = paircount.labeled_pair_count(
        pos, labels, 3, pos2=pos2, labels2=labels2, n_labels_2=2,
        period=L, kind="rppi", r_edges=rp_bins, pi_max=10.0)
    got = native.labeled_pair_count(
        pos, labels, 3, pos2=pos2, labels2=labels2, n_labels_2=2,
        period=L, kind="rppi", r_edges=rp_bins, pi_max=10.0)
    np.testing.assert_array_equal(got, want)


def test_native_negative_labels_ignored(data):
    L, pos, labels = data
    labels = labels.copy()
    labels[:100] = -1
    rp_bins = np.logspace(-0.5, 1.0, 4)
    want = paircount.labeled_pair_count(
        pos, labels, 3, period=L, kind="rppi", r_edges=rp_bins, pi_max=5.0)
    got = native.labeled_pair_count(
        pos, labels, 3, period=L, kind="rppi", r_edges=rp_bins, pi_max=5.0)
    np.testing.assert_array_equal(got, want)


def test_native_backend_tabulate_matches_device():
    import tabcorr_tpu as tt
    from test_tabulate import synthetic_halocat

    halocat = synthetic_halocat(n_halos=500, seed=2)
    rp_bins = np.logspace(-0.3, 1.0, 4)
    kwargs = dict(mode="auto", prim_haloprop_bins=4,
                  Num_ptcl_requirement=300, sats_per_prim_haloprop=1e-12,
                  seed=31)
    tab_dev = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp_bins, 10.0,
                                  **kwargs)
    tab_nat = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp_bins, 10.0,
                                  backend="native", **kwargs)
    # Identical mock realization (same seed); identical counts: the device
    # kernel computes pair geometry in float32 vs the native counter's
    # float64, so only bin-edge pairs can differ.
    np.testing.assert_allclose(tab_nat.tpcf_matrix, tab_dev.tpcf_matrix,
                               rtol=1e-4, atol=1e-4)


def test_native_nonuniform_mu_raises(data):
    pos, labels = data[0], data[1]
    mu_edges = np.array([0.0, 0.3, 1.0])
    s_edges = np.logspace(-0.5, 1.0, 4)
    with pytest.raises(ValueError, match="uniform"):
        native.labeled_pair_count(
            pos, labels, 4, period=50.0, kind="smu", r_edges=s_edges,
            mu_edges=mu_edges)


def test_native_log_weight_matches_jax(data):
    L, pos, labels = data
    ptcls = np.random.default_rng(9).uniform(0, L, (700, 3))
    edges = np.array([0.0, 1.0, 3.0, 9.0])
    want = paircount.labeled_pair_count(
        pos, labels, 3, pos2=ptcls, period=L, kind="proj",
        r_edges=edges, pair_weight="log_rp")
    got = native.labeled_pair_count(
        pos, labels, 3, pos2=ptcls, period=L, kind="proj",
        r_edges=edges, pair_weight="log_rp")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_native_backend_delta_sigma_matches_device():
    # The annulus_mean estimator through the native counters equals the
    # device path.
    from tabcorr_tpu.tabulate import _FastPath

    rng = np.random.default_rng(12)
    L = 80.0
    pos = rng.uniform(0, L, (600, 3))
    labels = rng.integers(0, 3, 600).astype(np.int32)
    ptcls = rng.uniform(0, L, (4000, 3))
    rp_bins = np.logspace(-0.3, 1.0, 5)
    args = (ptcls, 1e9, rp_bins)

    m_dev = _FastPath("mean_delta_sigma", args, {}).matrix_cross(
        pos, labels, 3, np.full(3, L))
    m_nat = _FastPath("mean_delta_sigma", args, {},
                      backend="native").matrix_cross(
        pos, labels, 3, np.full(3, L))
    # Uniform-random particles make delta-sigma a near-cancelling
    # difference, amplifying the device kernel's float32 pair geometry
    # against the native float64 one; compare against the overall
    # delta-sigma scale rather than per-element (near-zero entries).
    np.testing.assert_allclose(m_nat, m_dev, rtol=2e-3,
                               atol=2e-4 * np.max(np.abs(m_dev)))


def test_auto_strategy_routes_to_native_on_cpu():
    # On a CPU-only host, labeled_pair_count(strategy='auto') must route
    # to the (much faster) C++ counter when it can serve the call
    # exactly, and the result must equal an explicit strategy='native'
    # call bit-for-bit.  smu with non-uniform mu bins must fall back.
    from tabcorr_tpu.ops.paircount import labeled_pair_count

    rng = np.random.default_rng(5)
    N = 1200
    pos = rng.uniform(0, 60.0, (N, 3))
    labels = rng.integers(0, 3, N).astype(np.int32)
    r_edges = np.logspace(-0.5, 1.0, 5)

    got_auto = labeled_pair_count(pos, labels, 3, period=60.0,
                                  kind="rppi", r_edges=r_edges,
                                  pi_max=8.0)
    got_nat = labeled_pair_count(pos, labels, 3, period=60.0,
                                 kind="rppi", r_edges=r_edges,
                                 pi_max=8.0, strategy="native")
    assert isinstance(got_auto, np.ndarray)
    np.testing.assert_array_equal(got_auto, got_nat)

    # Non-uniform mu bins cannot run natively: auto must still succeed
    # (scatter fallback), matching the explicit scatter result.
    mu_nonuniform = np.array([0.0, 0.3, 1.0])
    got_auto2 = labeled_pair_count(pos, labels, 3, period=60.0,
                                   kind="smu", r_edges=r_edges,
                                   mu_edges=mu_nonuniform)
    got_scatter = labeled_pair_count(pos, labels, 3, period=60.0,
                                     kind="smu", r_edges=r_edges,
                                     mu_edges=mu_nonuniform,
                                     strategy="scatter")
    np.testing.assert_array_equal(np.asarray(got_auto2),
                                  np.asarray(got_scatter))


@pytest.mark.parametrize("backend,kind,mu,mesh,want", [
    ("cpu", "rppi", None, False, "native"),
    ("gpu", "rppi", None, False, "native"),
    ("cpu", "rppi", None, True, "scatter"),
    ("gpu", "rppi", None, True, "matmul"),
    ("gpu", "smu", (0.0, 0.3, 1.0), False, "matmul"),
    ("cpu", "smu", (0.0, 0.5, 1.0), False, "native"),
])
def test_auto_strategy_rule(monkeypatch, backend, kind, mu, mesh, want):
    # The host counter wherever it can serve the call; otherwise the
    # device sweep that suits the platform.
    from tabcorr_tpu.ops import paircount

    monkeypatch.setattr(paircount.jax, "default_backend", lambda: backend)
    got = paircount.auto_strategy(kind, None if mu is None else
                                  np.asarray(mu), object() if mesh else None)
    assert got == want


def test_artifact_path_falls_back_to_cache(monkeypatch, tmp_path):
    # A read-only site-packages install must build into the user cache,
    # keyed by ABI version and host ISA (-march=native artifacts must
    # not be shared across heterogeneous machines).
    monkeypatch.setattr(native.os, "access", lambda p, m: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    p = native._artifact_path()
    assert p.parent == tmp_path / "tabcorr_tpu"
    assert p.parent.is_dir()
    assert f"v{native.NATIVE_ABI_VERSION}_" in p.name
    assert native._isa_tag() in p.name
    # Writable source dir (a development checkout) builds next to it.
    monkeypatch.setattr(native.os, "access", lambda p, m: True)
    assert native._artifact_path().parent == native._NATIVE_DIR


def test_artifact_path_unwritable_cache_is_unavailable(monkeypatch,
                                                       tmp_path):
    # A locked-down host (read-only package dir AND unwritable cache)
    # must surface NativeUnavailable — not an import-time crash — so
    # strategy='auto' can fall back to the XLA scatter path.
    monkeypatch.setattr(native.os, "access", lambda p, m: False)
    blocked = tmp_path / "file"
    blocked.write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocked))  # mkdir fails
    with pytest.raises(native.NativeUnavailable):
        native._artifact_path()


@pytest.mark.parametrize("seed", [6, 17, 23, 31])
def test_native_fuzz_vs_bruteforce_oracle(seed):
    # Randomized geometries (anisotropic boxes, out-of-box positions,
    # dropped labels, r-bins possibly starting at 0, every kind and
    # weight channel, auto and cross) against an O(N^2) minimum-image
    # oracle.  Unit counts must match exactly when unweighted; weighted
    # channels to 1e-10 (summation order).
    rng = np.random.default_rng(seed)
    n1 = int(rng.integers(50, 300))
    box = np.array([rng.uniform(5, 60) for _ in range(3)])
    kind = str(rng.choice(["rppi", "proj", "smu"]))
    auto = bool(rng.integers(0, 2))
    n_lab1 = int(rng.integers(1, 6))
    pos1 = rng.uniform(-10, 70, (n1, 3))
    l1 = rng.integers(-1, n_lab1, n1).astype(np.int32)
    if auto:
        pos2, l2, n_lab2, weights2 = pos1, l1, n_lab1, None
        w2 = np.ones(n1)
    else:
        n2 = int(rng.integers(50, 300))
        n_lab2 = int(rng.integers(1, 6))
        pos2 = rng.uniform(-10, 70, (n2, 3))
        l2 = rng.integers(-1, n_lab2, n2).astype(np.int32)
        w2 = rng.uniform(0.1, 3.0, n2)
        weights2 = w2
    n_r = int(rng.integers(1, 8))
    lo = rng.choice([0.0, rng.uniform(0.05, 0.5)])
    r_edges = np.unique(np.concatenate(
        [[lo], np.sort(rng.uniform(max(lo, 0.1), min(box) * 0.45, n_r))]))
    pi_max = float(rng.uniform(0.5, min(box[2] * 0.45, 20.0)))
    n_mu = int(rng.integers(1, 6))
    pair_weight = str(rng.choice(["unit", "log_rp", "unit+log_rp"]))
    kw = {}
    if kind == "smu":
        kw["mu_edges"] = np.linspace(0, 1, n_mu + 1)
    if kind == "rppi":
        kw["pi_max"] = pi_max

    got = np.asarray(native.labeled_pair_count(
        pos1, l1, n_lab1,
        pos2=None if auto else pos2, labels2=None if auto else l2,
        n_labels_2=None if auto else n_lab2, weights2=weights2,
        period=box, kind=kind, r_edges=r_edges,
        pair_weight=pair_weight, **kw)).ravel()

    # O(N^2) minimum-image oracle.
    d = pos1[:, None, :] - pos2[None, :, :]
    d -= box * np.round(d / box)
    rp2 = d[..., 0] ** 2 + d[..., 1] ** 2
    dz = np.abs(d[..., 2])
    e2 = r_edges ** 2
    nsub = (len(r_edges) - 1) * (n_mu if kind == "smu" else 1)
    nch = 2 if pair_weight == "unit+log_rp" else 1
    want = np.zeros((nch, n_lab1, n_lab2, nsub))
    for i in range(len(pos1)):
        if l1[i] < 0:
            continue
        for j in range(len(pos2)):
            if (auto and i == j) or l2[j] < 0:
                continue
            if kind == "smu":
                v = rp2[i, j] + dz[i, j] ** 2
                if v <= 0 or v < e2[0] or v >= e2[-1]:
                    continue
                sb = np.searchsorted(e2, v, side="right") - 1
                mb = min(int(dz[i, j] / np.sqrt(v) * n_mu), n_mu - 1)
                sub = sb * n_mu + mb
            else:
                if kind == "rppi" and dz[i, j] >= pi_max:
                    continue
                v = rp2[i, j]
                if v < e2[0] or v >= e2[-1]:
                    continue
                sub = np.searchsorted(e2, v, side="right") - 1
            w = w2[j]
            lw = w * 0.5 * np.log(max(rp2[i, j], 1e-20))
            if pair_weight in ("unit", "unit+log_rp"):
                want[0, l1[i], l2[j], sub] += w
            if pair_weight == "log_rp":
                want[0, l1[i], l2[j], sub] += lw
            elif pair_weight == "unit+log_rp":
                want[1, l1[i], l2[j], sub] += lw
    want = want.ravel()
    if pair_weight == "unit" and weights2 is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


def test_native_thread_count_invariance(tmp_path):
    # The OpenMP merge (per-thread partials summed in thread-id order)
    # must not change results with the thread count.  OMP_NUM_THREADS is
    # read at library load, so each count runs in its own subprocess.
    import subprocess
    import sys

    script = tmp_path / "count.py"
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        "from tabcorr_tpu import native\n"
        "rng = np.random.default_rng(11)\n"
        "pos1 = rng.uniform(0, 80, (1500, 3))\n"
        "pos2 = rng.uniform(0, 80, (1200, 3))\n"
        "l1 = rng.integers(0, 4, 1500).astype(np.int32)\n"
        "l2 = rng.integers(0, 3, 1200).astype(np.int32)\n"
        "w2 = rng.uniform(0.5, 2.0, 1200)\n"
        "r = np.logspace(-0.5, 1.2, 7)\n"
        "a = native.labeled_pair_count(pos1, l1, 4, period=80.0,\n"
        "    kind='rppi', r_edges=r, pi_max=12.0)\n"
        "b = native.labeled_pair_count(pos1, l1, 4, pos2=pos2, labels2=l2,\n"
        "    n_labels_2=3, weights2=w2, period=80.0, kind='proj',\n"
        "    r_edges=r, pair_weight='unit+log_rp')\n"
        "np.savez(sys.argv[1], a=a, b=b)\n")

    import os
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = {}
    for n in ["1", "4"]:
        out = tmp_path / f"counts_{n}.npz"
        env = dict(os.environ, OMP_NUM_THREADS=n, JAX_PLATFORMS="cpu",
                   PYTHONPATH=repo_root)
        subprocess.run([sys.executable, str(script), str(out)],
                       check=True, timeout=300, env=env, cwd=repo_root)
        results[n] = np.load(out)

    # Unit counts are integer-exact; weighted sums agree to f64 roundoff
    # (the merge order over threads is fixed, but the per-thread
    # partition of i-rows is dynamic).
    np.testing.assert_array_equal(results["1"]["a"], results["4"]["a"])
    np.testing.assert_allclose(results["1"]["b"], results["4"]["b"],
                               rtol=1e-12, atol=1e-12)


def test_native_out_of_range_labels_dropped(data):
    # Labels >= n_labels are dropped exactly like negatives (the device
    # twin's one-hot/scatter semantics) — not written past the histogram.
    L, pos, labels = data
    r = np.logspace(-0.5, 1.0, 4)
    bad = labels.copy()
    bad[::7] = 3  # == n_labels
    neg = labels.copy()
    neg[::7] = -1
    kw = dict(period=L, kind="rppi", r_edges=r, pi_max=12.0)
    a = native.labeled_pair_count(pos, bad, 3, **kw)
    b = native.labeled_pair_count(pos, neg, 3, **kw)
    np.testing.assert_array_equal(a, b)


def test_native_rppi_requires_pi_max(data):
    L, pos, labels = data
    r = np.logspace(-0.5, 1.0, 4)
    with pytest.raises(ValueError, match="pi_max"):
        native.labeled_pair_count(pos, labels, 3, period=L,
                                  kind="rppi", r_edges=r)


def test_native_null_labels2_weights2_match_explicit(data):
    L, pos, labels = data
    pos2 = np.random.default_rng(8).uniform(0, L, (400, 3))
    r = np.logspace(-0.5, 1.0, 4)
    kw = dict(period=L, kind="proj", r_edges=r)
    a = native.labeled_pair_count(pos, labels, 3, pos2=pos2, **kw)
    b = native.labeled_pair_count(
        pos, labels, 3, pos2=pos2,
        labels2=np.zeros(len(pos2), dtype=np.int32), n_labels_2=1,
        weights2=np.ones(len(pos2)), **kw)
    np.testing.assert_array_equal(a, b)
