"""Statistics layer vs NumPy oracles (SURVEY §4 oracles (f),(g))."""

import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.state import StepObs
from ljmd_tpu.stats.correlations import autocorr, autocorr_all, block_corr_means, normalize_corr
from ljmd_tpu.stats.moments import (
    OBSERVABLES,
    instantaneous_temp_press,
    means_finalize,
    means_init,
    means_update,
)
from ljmd_tpu.stats.thermo import thermo_coefs


# ----------------------------------------------------------------------
# NumPy oracles written directly from the definitions
# ----------------------------------------------------------------------
def np_autocorr(a, max_lag, centered=False):
    a = np.asarray(a, dtype=np.float64)
    if centered:
        a = a - a.mean()
    n = len(a)
    return np.array([np.dot(a[: n - L], a[L:]) / (n - L) for L in range(max_lag + 1)])


def synth_series(n=400, seed=0):
    rng = np.random.default_rng(seed)
    # AR(1)-ish correlated series
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = 0.9 * x[i - 1] + rng.normal()
    return x + 3.0


def test_autocorr_raw_and_centered_vs_numpy():
    x = synth_series()
    for centered in (False, True):
        got = np.asarray(autocorr(jnp.asarray(x), 50, centered=centered))
        want = np_autocorr(x, 50, centered=centered)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_autocorr_rejects_bad_lag():
    with pytest.raises(ValueError):
        autocorr(jnp.zeros(10), 10)


def test_normalize_corr():
    c = jnp.asarray(np.array([4.0, 2.0, 1.0]))
    np.testing.assert_allclose(np.asarray(normalize_corr(c)), [1.0, 0.5, 0.25])
    z = jnp.zeros(3)
    np.testing.assert_allclose(np.asarray(normalize_corr(z)), 0.0)


def test_autocorr_all_batches():
    x = synth_series(seed=1)
    y = synth_series(seed=2)
    corr, corrn = autocorr_all(jnp.stack([jnp.asarray(x), jnp.asarray(y)]), 20)
    np.testing.assert_allclose(np.asarray(corr[0]), np_autocorr(x, 20, True), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(corr[1]), np_autocorr(y, 20, True), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(corrn[0]), np.asarray(corr[0] / corr[0][0]), rtol=1e-12)


def test_block_corr_means_vs_numpy():
    x = synth_series(n=437, seed=3)  # non-divisible length: remainder dropped
    n_blocks, max_lag = 4, 25
    block_len = 437 // n_blocks
    mc, mcn = block_corr_means(jnp.asarray(x), n_blocks, max_lag, centered=True)
    # oracle
    accs, accns = [], []
    for b in range(n_blocks):
        blk = x[b * block_len : (b + 1) * block_len]
        c = np_autocorr(blk, max_lag, centered=True)
        accs.append(c)
        accns.append(c / c[0])
    np.testing.assert_allclose(np.asarray(mc), np.mean(accs, axis=0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(mcn), np.mean(accns, axis=0), rtol=1e-12)


def test_block_corr_means_validation():
    x = jnp.asarray(synth_series(100))
    with pytest.raises(ValueError):
        block_corr_means(x, 4, 25)  # block_len=25, max_lag must be < 25
    with pytest.raises(ValueError):
        block_corr_means(x, 0, 5)


# ----------------------------------------------------------------------
# Streaming means
# ----------------------------------------------------------------------
def test_means_accumulator_vs_numpy():
    rng = np.random.default_rng(0)
    n, volume = 100, 125.0
    n_samp = 57
    U = rng.normal(-300, 5, n_samp)
    K = rng.normal(150, 4, n_samp)
    dU = rng.normal(-900, 30, n_samp)
    ddU = rng.normal(12000, 200, n_samp)

    acc = means_init(dtype=jnp.float64)
    for i in range(n_samp):
        obs = StepObs(
            epot=jnp.asarray(U[i]),
            ekin=jnp.asarray(K[i]),
            d_epot=jnp.asarray(dU[i]),
            dd_epot=jnp.asarray(ddU[i]),
        )
        acc = means_update(acc, obs, n, volume)
    rep = means_finalize(acc)

    T = 2 * K / (3 * n)
    P = (n / volume) * T + (-dU) / (3 * volume)
    expected = {
        "epot": U,
        "ekin": K,
        "etot": U + K,
        "temp": T,
        "press": P,
        "ekin_inv": 1 / K,
        "d_epot": dU,
        "dd_epot": ddU,
        "d_epot_ekin_inv": dU / K,
        "d_epot2_ekin_inv": dU**2 / K,
        "dd_epot_ekin_inv": ddU / K,
    }
    assert int(rep.count) == n_samp
    for name in OBSERVABLES:
        x = expected[name]
        assert float(rep.mean(name)) == pytest.approx(x.mean(), rel=1e-12), name
        want_std = np.sqrt(np.maximum((x**2).mean() - x.mean() ** 2, 0))
        assert float(rep.std(name)) == pytest.approx(want_std, rel=1e-9), name


def test_means_std_f32_no_cancellation():
    """Shifted moments keep a tiny variance on a huge mean in f32 (the raw
    <x^2>-<x>^2 form reported Etot std 3.6 where the true series std was
    0.025 on an f32 reference-default run)."""
    rng = np.random.default_rng(1)
    n, volume = 500, 1000.0
    n_samp = 500
    etot_mean, etot_std = -554.8, 0.025
    etot = rng.normal(etot_mean, etot_std, n_samp)
    K = rng.normal(1110.0, 18.0, n_samp)
    U = etot - K

    acc = means_init(dtype=jnp.float32)
    for i in range(n_samp):
        obs = StepObs(
            epot=jnp.asarray(U[i], jnp.float32),
            ekin=jnp.asarray(K[i], jnp.float32),
            d_epot=jnp.asarray(0.0, jnp.float32),
            dd_epot=jnp.asarray(0.0, jnp.float32),
        )
        acc = means_update(acc, obs, n, volume)
    rep = means_finalize(acc)

    want = float(np.sqrt(np.mean(etot**2) - np.mean(etot) ** 2))
    got = float(rep.std("etot"))
    # raw f32 moments give ~3.6 here (144x off); shifted moments are good
    # to f32 sampling error on the deviations themselves
    assert got == pytest.approx(want, rel=2e-3)
    assert float(rep.mean("etot")) == pytest.approx(etot.mean(), rel=1e-6)


def test_instantaneous_temp_press():
    obs = StepObs(
        epot=jnp.asarray(-10.0),
        ekin=jnp.asarray(6.0),
        d_epot=jnp.asarray(-30.0),
        dd_epot=jnp.asarray(0.0),
    )
    t, p = instantaneous_temp_press(obs, n=4, volume=8.0)
    assert float(t) == pytest.approx(2 * 6.0 / 12.0)  # 2K/(3N)
    assert float(p) == pytest.approx((4 / 8.0) * 1.0 + 30.0 / 24.0)  # rhoT + W/3V


# ----------------------------------------------------------------------
# Thermodynamic coefficients: direct NumPy evaluation of the canonical
# formulas (thermodynamic_coefs.f90:104-203)
# ----------------------------------------------------------------------
def test_thermo_coefs_vs_numpy_oracle():
    n, volume = 500, 1000.0
    means = dict(
        ekin_mean=741.0,
        press_mean=1.83,
        ekin_inv_mean=1.0 / 740.0,
        d_epot_mean=-2950.0,
        dd_epot_mean=41000.0,
        d_epot_ekin_inv_mean=-3.99,
        d_epot2_ekin_inv_mean=11900.0,
    )
    out = thermo_coefs(n, volume, **means)

    npd = float(n)
    f = 3 * npd - 3
    aux1 = 1 - 2 / f
    aux2 = f / 2 - 1
    T = 2 * means["ekin_mean"] / f
    ca_v = 1 / (1 - aux1 * means["ekin_mean"] * means["ekin_inv_mean"])
    ce_v = ca_v / npd
    gamma = 1 / ce_v + (aux2 / 3) * (
        means["d_epot_mean"] * means["ekin_inv_mean"] - means["d_epot_ekin_inv_mean"]
    )
    k_s_aux = (npd * T * (1 + 2 * gamma - 1 / ce_v)) / volume + (
        means["dd_epot_mean"] - 2 * means["d_epot_mean"]
    ) / (9 * volume)
    k_s = k_s_aux - aux2 * (
        means["d_epot2_ekin_inv_mean"]
        - 2 * means["d_epot_mean"] * means["d_epot_ekin_inv_mean"]
        + means["d_epot_mean"] ** 2 * means["ekin_inv_mean"]
    ) / (9 * volume**2)
    k_t = k_s - T * ca_v * gamma**2 / volume

    assert float(out.temperature) == pytest.approx(T, rel=1e-12)
    assert float(out.pressure) == pytest.approx(means["press_mean"], rel=1e-12)
    assert float(out.Ca_v) == pytest.approx(ca_v, rel=1e-12)
    assert float(out.Ce_v) == pytest.approx(ce_v, rel=1e-12)
    assert float(out.gamma) == pytest.approx(gamma, rel=1e-12)
    assert float(out.K_S) == pytest.approx(k_s, rel=1e-12)
    assert float(out.K_S_inv) == pytest.approx(1 / k_s, rel=1e-12)
    assert float(out.K_T) == pytest.approx(k_t, rel=1e-12)
    assert float(out.Ca_p) == pytest.approx(ca_v * k_s / k_t, rel=1e-12)
    assert float(out.alpha_E1) == pytest.approx(
        1 / (means["press_mean"] * volume / ca_v - gamma * T), rel=1e-12
    )
    assert float(out.alpha_E2) == pytest.approx(
        1 / ((1 / 3) * (aux1 * means["ekin_mean"] * means["d_epot_ekin_inv_mean"] - means["d_epot_mean"])),
        rel=1e-12,
    )
    assert float(out.alpha_S) == pytest.approx(-1 / (gamma * T), rel=1e-12)
    assert float(out.alpha_P) == pytest.approx(ca_v * gamma / (volume * k_t), rel=1e-12)
    out.check_finite()


def test_thermo_check_finite_raises():
    # Degenerate means: <K><1/K> makes the Ca_v denominator ~0 is hard to hit
    # exactly; instead force gamma*T = 0 via zero kinetic energy -> nan/inf.
    out = thermo_coefs(10, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    with pytest.raises(FloatingPointError):
        out.check_finite()


def test_thermo_rejects_n_too_small():
    with pytest.raises(ValueError):
        thermo_coefs(1, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("n", [100, 2000])
def test_autocorr_f32_matches_float64_numpy(n):
    """The f32 autocorrelation of a centred series with a tiny variance (an
    NVE Etot trace) against float64 numpy on the same f32 input: the dot
    runs at HIGHEST precision, so the error stays at f32 accumulation level
    (a TF32 dot would err ~5e-4 per product)."""
    rng = np.random.default_rng(n)
    etot = -18800.0 + 0.05 * np.cumsum(rng.normal(size=n)) / np.sqrt(n)
    x = (etot - etot.mean()).astype(np.float32)
    max_lag = n // 2
    got = np.asarray(autocorr(jnp.asarray(x), max_lag, centered=False), np.float64)
    x64 = x.astype(np.float64)
    want = np.array([x64[: n - L] @ x64[L:] / (n - L) for L in range(max_lag + 1)])
    assert float(np.max(np.abs(got - want))) <= 1e-5 * want[0]
