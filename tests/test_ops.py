"""Unit tests for geometry + dense LJ kernels against analytic values and an
independent NumPy i<j oracle (SURVEY §4 oracles (a), (d), (e))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.config import SimConfig, config_from_density
from ljmd_tpu.models.lattice import fcc_lattice
from ljmd_tpu.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu.ops.lj import (
    lj_force_energy_dense,
    lj_from_config,
    lj_potential_dense,
    tail_corrections,
)


# ----------------------------------------------------------------------
# Independent NumPy oracle: straightforward i<j pair loop (vectorized via
# triu indices), written directly from the LJ definitions.
# ----------------------------------------------------------------------
def numpy_lj_oracle(r, L, rc):
    r = np.asarray(r, dtype=np.float64)
    n = r.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    d = r[iu] - r[ju]
    d -= L * np.round(d / L)
    r2 = (d * d).sum(axis=1)
    sel = r2 < rc * rc
    r2 = r2[sel]
    inv2 = 1.0 / r2
    inv6 = inv2**3
    inv12 = inv6**2
    epot = 4.0 * np.sum(inv12 - inv6)
    d_epot = 24.0 * np.sum(-2.0 * inv12 + inv6)
    dd_epot = 24.0 * np.sum(26.0 * inv12 - 7.0 * inv6)
    # forces
    f = np.zeros_like(r)
    coef = 24.0 * (2.0 * inv12 - inv6) * inv2  # -dU/dr / r
    fij = coef[:, None] * d[sel]
    np.add.at(f, iu[sel], fij)
    np.add.at(f, ju[sel], -fij)
    return f, epot, d_epot, dd_epot


def random_fluid(n=64, L=5.0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, L, size=(n, 3))


def test_wrap_positions():
    r = jnp.array([-0.1, 0.0, 4.999, 5.0, 5.1, 12.3], dtype=jnp.float64)
    w = wrap_positions(r, 5.0)
    np.testing.assert_allclose(np.asarray(w), [4.9, 0.0, 4.999, 0.0, 0.1, 2.3], atol=1e-12)
    assert bool(jnp.all((w >= 0) & (w < 5.0)))


def test_minimum_image():
    L = 10.0
    d = jnp.array([-9.8, 9.8, 4.9, -4.9, 5.1, 0.3], dtype=jnp.float64)
    m = minimum_image(d, L)
    np.testing.assert_allclose(np.asarray(m), [0.2, -0.2, 4.9, -4.9, -4.9, 0.3], atol=1e-12)
    assert bool(jnp.all(jnp.abs(m) <= L / 2 + 1e-12))


def test_two_particle_analytic():
    """Two particles at distance r: closed-form U, r dU/dr, r^2 d2U/dr2, |F|."""
    L, rc = 20.0, 9.0
    for dist in (0.9, 1.0, 2 ** (1 / 6), 1.5, 3.0):
        r = jnp.array([[1.0, 1.0, 1.0], [1.0 + dist, 1.0, 1.0]], dtype=jnp.float64)
        res = lj_force_energy_dense(r, L, rc * rc, use_tail_corrections=False)
        inv6 = dist**-6
        inv12 = inv6**2
        assert float(res.epot) == pytest.approx(4 * (inv12 - inv6), rel=1e-12)
        assert float(res.d_epot) == pytest.approx(24 * (-2 * inv12 + inv6), rel=1e-12)
        assert float(res.dd_epot) == pytest.approx(24 * (26 * inv12 - 7 * inv6), rel=1e-12)
        fmag = 24 * (2 * inv12 - inv6) / dist  # -dU/dr
        np.testing.assert_allclose(
            np.asarray(res.a),
            [[-fmag, 0, 0], [fmag, 0, 0]],
            rtol=1e-12,
            atol=1e-12,
        )


def test_cutoff_excludes_pairs():
    L = 20.0
    r = jnp.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]], dtype=jnp.float64)
    res = lj_force_energy_dense(r, L, 2.5**2, use_tail_corrections=False)
    assert float(res.epot) == 0.0
    assert float(jnp.abs(res.a).max()) == 0.0


def test_minimum_image_interaction_across_boundary():
    L, rc = 10.0, 4.0
    r = jnp.array([[0.2, 5.0, 5.0], [9.9, 5.0, 5.0]], dtype=jnp.float64)  # true dist 0.3
    res = lj_force_energy_dense(r, L, rc * rc, use_tail_corrections=False)
    inv6 = 0.3**-6
    inv12 = inv6**2
    assert float(res.epot) == pytest.approx(4 * (inv12 - inv6), rel=1e-10)


def test_dense_matches_numpy_oracle():
    L, rc = 5.0, 2.4
    r = random_fluid(n=64, L=L)
    f0, e0, d0, dd0 = numpy_lj_oracle(r, L, rc)
    res = lj_force_energy_dense(jnp.asarray(r), L, rc * rc, use_tail_corrections=False)
    assert float(res.epot) == pytest.approx(e0, rel=1e-10)
    assert float(res.d_epot) == pytest.approx(d0, rel=1e-10)
    assert float(res.dd_epot) == pytest.approx(dd0, rel=1e-10)
    np.testing.assert_allclose(np.asarray(res.a), f0, rtol=1e-9, atol=1e-9)


def test_tail_corrections_closed_form():
    # Reference formulas (lj_potential_energy.f90:208-212); standard
    # textbook form U_tail = (8/3) pi N rho [ (1/3) rc^-9 - rc^-3 ] * N/... —
    # validate the implemented identity numerically against an explicit
    # high-resolution integral of the missing g(r)=1 contribution.
    n, V, rc = 500, 1000.0, 2.5
    e_t, d_t, dd_t = tail_corrections(n, V, rc)
    rho = n / V
    # U_tail = 2 pi N rho * int_rc^inf 4(r^-12 - r^-6) r^2 dr
    rr = np.linspace(rc, 400.0, 4_000_000)
    u = 4 * (rr**-12.0 - rr**-6.0)
    e_int = 2 * np.pi * n * rho * np.trapezoid(u * rr**2, rr)
    assert e_t == pytest.approx(e_int, rel=1e-6)
    # r dU/dr tail: 2 pi N rho * int rc^inf (r dU/dr) r^2 dr,
    # r dU/dr = 24(-2 r^-12 + r^-6)
    du = 24 * (-2.0 * rr**-12.0 + rr**-6.0)
    d_int = 2 * np.pi * n * rho * np.trapezoid(du * rr**2, rr)
    assert d_t == pytest.approx(d_int, rel=1e-6)
    dd = 24 * (26.0 * rr**-12.0 - 7.0 * rr**-6.0)
    dd_int = 2 * np.pi * n * rho * np.trapezoid(dd * rr**2, rr)
    assert dd_t == pytest.approx(dd_int, rel=1e-6)


def test_force_is_minus_grad_potential():
    cfg = config_from_density(num_cells=2, density=0.7, dtype="float64")
    rng = np.random.default_rng(3)
    r = jnp.asarray(rng.uniform(0, cfg.box_length, size=(cfg.n, 3)))

    for tails in (False, True):
        grad_u = jax.grad(
            lambda x: lj_potential_dense(
                x, cfg.box_length, cfg.rc_square, tails, cfg.volume, cfg.rc
            )
        )(r)
        res = lj_force_energy_dense(
            r, cfg.box_length, cfg.rc_square, tails, cfg.volume, cfg.rc
        )
        np.testing.assert_allclose(np.asarray(res.a), -np.asarray(grad_u), rtol=1e-8, atol=1e-8)


def test_forces_sum_to_zero():
    # Physical configuration (jittered lattice, no overlaps): Newton's 3rd
    # law must make the total force vanish to round-off.
    cfg = SimConfig(dtype="float64")
    rng = np.random.default_rng(7)
    r = np.asarray(fcc_lattice(cfg.num_cells, cfg.box_length, dtype=jnp.float64))
    r = (r + rng.normal(scale=0.05, size=r.shape)) % cfg.box_length
    res = lj_from_config(jnp.asarray(r), cfg)
    fmax = float(jnp.abs(res.a).max())
    np.testing.assert_allclose(np.asarray(res.a.sum(axis=0)), 0.0, atol=1e-10 * max(fmax, 1.0))


def test_fcc_lattice_structure():
    cfg = SimConfig(num_cells=1, box_length=2.0)
    r = fcc_lattice(1, 2.0, dtype=jnp.float64)
    assert r.shape == (4, 3)
    np.testing.assert_allclose(
        np.asarray(r),
        [[0, 0, 0], [0, 1, 1], [1, 0, 1], [1, 1, 0]],
        atol=1e-15,
    )
    assert cfg.n == 4


def test_fcc_lattice_reference_ordering_and_bounds():
    k, L = 3, 6.0
    r = np.asarray(fcc_lattice(k, L, dtype=jnp.float64))
    assert r.shape == (4 * k**3, 3)
    assert (r >= 0).all() and (r < L).all()
    # Cell-major ordering: first 4 atoms are the basis of cell (0,0,0),
    # next 4 the basis of cell (0,0,1) (iz fastest), matching the reference's
    # ix/iy/iz nesting (md_initial_config_program.f90:144-146).
    a = L / k
    np.testing.assert_allclose(r[4:8], np.array(
        [[0, 0, a], [0, a / 2, 1.5 * a], [a / 2, 0, 1.5 * a], [a / 2, a / 2, a]]
    ), atol=1e-15)
    # All particles distinct
    assert len(np.unique(np.round(r, 9), axis=0)) == r.shape[0]


def test_fcc_energy_matches_oracle():
    cfg = config_from_density(num_cells=3, density=0.9, dtype="float64")
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=jnp.float64)
    f0, e0, d0, dd0 = numpy_lj_oracle(np.asarray(r), cfg.box_length, cfg.rc)
    res = lj_force_energy_dense(r, cfg.box_length, cfg.rc_square, use_tail_corrections=False)
    assert float(res.epot) == pytest.approx(e0, rel=1e-10)
    # Perfect lattice: forces vanish by symmetry
    assert float(jnp.abs(res.a).max()) < 1e-8


# ----------------------------------------------------------------------
# _pair_terms: the per-pair LJ algebra every engine shares
# ----------------------------------------------------------------------
def _r2_grid(dtype):
    # the interaction range incl. the zero-force point r = 2^(1/6), r = 1,
    # the cutoff itself and sub-sigma close approaches
    r = np.concatenate([np.linspace(0.3, 3.2, 4001), [2.0 ** (1.0 / 6.0), 1.0, 2.5]])
    return jnp.asarray(r * r, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_pair_terms_match_f64_oracle(dtype):
    from ljmd_tpu.ops.lj import _pair_terms

    r2 = _r2_grid(dtype)
    mask = r2 < jnp.asarray(2.5 * 2.5, dtype)
    e, du, ddu, inv_r2 = _pair_terms(r2, mask, dtype)
    for x in (e, du, ddu, inv_r2):
        assert x.dtype == dtype
    m = np.asarray(mask)
    r2_64 = np.asarray(r2, np.float64)
    inv6 = (1.0 / r2_64) ** 3
    want = {
        "e": (inv6 * inv6 - inv6) * m,                 # U/4
        "du": (inv6 - 2 * inv6 * inv6) * m,            # r dU/dr / 24
        "ddu": (26 * inv6 * inv6 - 7 * inv6) * m,      # r^2 d2U/dr2 / 24
        "coef": (2 * inv6 * inv6 - inv6) / r2_64 * m,  # force coefficient / 24
    }
    got = {"e": e, "du": du, "ddu": ddu, "coef": -du * inv_r2}
    # relative where the terms are large; absolute near their zero
    # crossings (r = 1, 2^(1/6), (26/7)^(1/6)), where operands cancel
    rtol = 1e-5 if dtype == jnp.float32 else 1e-12
    for k in want:
        g = np.asarray(got[k], np.float64)
        err = np.abs(g - want[k]) / np.maximum(np.abs(want[k]), 1.0)
        assert float(err[m].max()) < rtol, k


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_pair_terms_zero_outside_mask(dtype):
    """Masked pairs — beyond the cutoff, and the self pair at r2 = 0 — give
    exactly zero and never inf/NaN (1/r2 is taken on a safe value)."""
    from ljmd_tpu.ops.lj import _pair_terms

    r2 = jnp.concatenate([_r2_grid(dtype), jnp.zeros((3,), dtype)])
    mask = (r2 < jnp.asarray(2.5 * 2.5, dtype)) & (r2 > 0)
    outs = _pair_terms(r2, mask, dtype)
    for x in outs:
        x = np.asarray(x)
        assert np.all(np.isfinite(x))
        np.testing.assert_array_equal(x[~np.asarray(mask)], 0.0)


def test_pair_terms_force_is_minus_gradient():
    """f_ij = 24 * coef * r_vec is -dU/dr_i of U = 4 * pair_e (autodiff)."""
    from ljmd_tpu.ops.lj import _pair_terms

    d = jnp.asarray(np.random.default_rng(0).uniform(0.4, 1.4, (64, 3)), jnp.float64)
    r2 = jnp.sum(d * d, axis=-1)
    mask = r2 < 6.25

    def energy(dv):
        return 4.0 * jnp.sum(_pair_terms(jnp.sum(dv * dv, -1), mask, jnp.float64)[0])

    _, du, _, inv_r2 = _pair_terms(r2, mask, jnp.float64)
    force = 24.0 * (-du * inv_r2)[:, None] * d
    np.testing.assert_allclose(np.asarray(force), -np.asarray(jax.grad(energy)(d)),
                               rtol=1e-10, atol=1e-10)
