"""The counting functions against hand counts at small shapes."""
from portbench import roofline


def test_chol_cost_by_hand():
    # n = 3: 6 lower entries read, 9 written; 3 roots, 3 divides, and the
    # trailing updates of 2 + 1 ... (n - 1) n (n + 1) / 3 = 8
    assert roofline.chol_cost(1, 3) == ((6 + 9) * 4, 3 + 3 + 8)
    assert roofline.chol_cost(5, 3) == (5 * 15 * 4, 5 * 14)


def test_solve_cost_by_hand():
    # n = 4, m = 2: 10 triangle entries, 8 in, 8 out; 16 operations a column
    assert roofline.solve_cost(3, 4, 2) == (3 * (10 + 16) * 4, 3 * 2 * 16)
    assert roofline.trsm_cost(4, 2) == roofline.solve_cost(1, 4, 2)


def test_potrf_cost_by_hand():
    assert roofline.potrf_cost(6) == (6 * 7 * 4, 72)


def test_step_counts_by_hand():
    # n = 3: 5 n^2 = 45, two n^3 / 3 = 9 each, two solves of n^3 = 27 each
    assert roofline.gpr_elbo_step(models=2, n=3) == 2 * (45 + 9 + 9 + 54)
    # 4 n^2 = 36 and the same cubic terms
    assert roofline.gpr_exact_step(models=1, n=3) == 36 + 9 + 9 + 54
    assert roofline.step_flops("gpr_exact_step", models=1, n=3) == 108


def test_bound_names_what_bounds_it():
    t, what = roofline.bound_s(3.35e12, 1.0)
    assert abs(t - 1.0) < 1e-12 and what == "bytes"
    t, what = roofline.bound_s(1.0, 67e12)
    assert abs(t - 1.0) < 1e-12 and what == "operations"
