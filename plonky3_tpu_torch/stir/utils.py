"""Polynomial utilities for the STIR protocol (stir/src/utils.rs).

Port of `plonky3_tpu/stir/utils.py`. The scalar helpers work on the
host over extension tuples (standard-form ints), as the reference's do.
The codeword-sized operations (the fold, the coset transforms) work on
(N, D) int64 Montgomery tensors on the codeword's device; every
transform goes through `ops.ntt` and so, on a CUDA tensor, through the
four-step kernels K1/K2.
"""

from __future__ import annotations

from ..fri.two_adic_pcs import _ext_powers_device
from ..ops.ntt import coset_evals_from_coeffs, idft, powers_device
from ..utils.bits import bitrev_permute_axis0, log2_strict


# ---------------------------------------------------------------------------
# scalar (host-exact) polynomial ops over extension tuples
# ---------------------------------------------------------------------------
def eval_poly(E, poly, point):
    """Horner evaluation; poly[0] is the constant term (utils.rs:22)."""
    acc = E.zero_h()
    for c in reversed(poly):
        acc = E.add_h(E.mul_h(acc, point), c)
    return acc


def divide_by_linear(E, poly, point):
    """(quotient, remainder) of poly / (X - point) (utils.rs:68)."""
    if not poly:
        raise ValueError("cannot divide an empty polynomial")
    n = len(poly)
    quotient = [E.zero_h()] * (n - 1)
    carry = E.zero_h()
    for i in range(n - 2, -1, -1):
        carry = E.add_h(poly[i + 1], E.mul_h(carry, point))
        quotient[i] = carry
    remainder = E.add_h(poly[0], E.mul_h(carry, point))
    return quotient, remainder


def add_polys(E, a, b):
    n = max(len(a), len(b))
    z = E.zero_h()
    return [
        E.add_h(a[i] if i < len(a) else z, b[i] if i < len(b) else z)
        for i in range(n)
    ]


def vanishing_poly_from_roots(E, roots):
    """Monic prod (X - y), ascending coefficients (utils.rs:148)."""
    coeffs = [E.one_h()]
    for root in roots:
        coeffs.append(E.zero_h())
        for i in range(len(coeffs) - 1, 0, -1):
            coeffs[i] = E.sub_h(coeffs[i - 1], E.mul_h(coeffs[i], root))
        coeffs[0] = E.neg_h(E.mul_h(coeffs[0], root))
    return coeffs


def interpolate_poly(E, points, values):
    """Newton divided differences -> ascending coefficients
    (utils.rs:246). Trailing zero coefficients are stripped."""
    if len(points) != len(values):
        raise ValueError("as many points as values are needed")
    n = len(points)
    if n == 0:
        return []
    dd = list(values)
    for k in range(1, n):
        for i in range(n - 1, k - 1, -1):
            denom = E.sub_h(points[i], points[i - k])
            dd[i] = E.mul_h(E.sub_h(dd[i], dd[i - 1]), E.inv_h(denom))
    coeffs = [E.zero_h()] * n
    coeffs[0] = dd[0]
    basis = [E.one_h()]
    for k in range(1, n):
        pk = points[k - 1]
        new_basis = [E.zero_h()] * (len(basis) + 1)
        for i, b in enumerate(basis):
            new_basis[i + 1] = E.add_h(new_basis[i + 1], b)
            new_basis[i] = E.sub_h(new_basis[i], E.mul_h(b, pk))
        basis = new_basis
        for i, b in enumerate(basis):
            coeffs[i] = E.add_h(coeffs[i], E.mul_h(dd[k], b))
    while len(coeffs) > 1 and coeffs[-1] == E.zero_h():
        coeffs.pop()
    return coeffs


def compute_shake_polynomial(E, ans, points):
    """S(X) = sum_y (ans(X) - ans(y)) / (X - y) (utils.rs:224)."""
    acc = []
    for y in points:
        q, _ = divide_by_linear(E, ans, y)
        acc = add_polys(E, acc, q)
    return acc


def check_shake_consistency(E, ans, shake, points, values, rho):
    """One-point shake identity check at rho (utils.rs:328)."""
    if len(points) != len(values):
        return False
    if rho in points:
        return False
    ans_rho = eval_poly(E, ans, rho)
    shake_rho = eval_poly(E, shake, rho)
    expected = E.zero_h()
    for y, val in zip(points, values):
        inv = E.inv_h(E.sub_h(rho, y))
        expected = E.add_h(
            expected, E.mul_h(E.sub_h(ans_rho, val), inv)
        )
    return shake_rho == expected


def reduce_mod_x_pow_minus_c(E, poly, n, c):
    """poly mod (X^n - c): fold coefficient i onto i%n scaled by
    c^(i//n) (utils.rs:127). c is a base-field int."""
    F = E.base
    rem = [E.zero_h()] * n
    c_pow = 1
    for start in range(0, len(poly), n):
        for slot, coeff in enumerate(poly[start : start + n]):
            rem[slot] = E.add_h(rem[slot], E.base_mul_h(c_pow, coeff))
        c_pow = F.mul_h(c_pow, c % F.P)
    return rem


def eval_degree_correction(E, value, point, r_comb, gap):
    """value · (1 - (r·x)^{gap+1}) / (1 - r·x) (utils.rs:103)."""
    step = E.mul_h(point, r_comb)
    if step == E.one_h():
        geom = E.from_base_h(gap + 1)
    else:
        num = E.sub_h(E.one_h(), E.exp_h(step, gap + 1))
        geom = E.mul_h(num, E.inv_h(E.sub_h(E.one_h(), step)))
    return E.mul_h(value, geom)


def lagrange_eval_at(E, xs, ys, point):
    """Barycentric Lagrange interpolation of (xs, ys) at `point`
    (utils.rs:482). xs are base-field ints; ys extension tuples."""
    F = E.base
    n = len(xs)
    # if point is one of the nodes, return the value directly
    for x, y in zip(xs, ys):
        if E.from_base_h(x) == point:
            return y
    # weights w_i = 1 / prod_{j != i} (x_i - x_j)
    result = E.zero_h()
    l_all = E.one_h()
    for x in xs:
        l_all = E.mul_h(l_all, E.sub_h(point, E.from_base_h(x)))
    for i in range(n):
        w = 1
        for j in range(n):
            if j != i:
                w = F.mul_h(w, F.sub_h(xs[i], xs[j]))
        denom = E.base_mul_h(w, E.sub_h(point, E.from_base_h(xs[i])))
        result = E.add_h(result, E.mul_h(ys[i], E.inv_h(denom)))
    return E.mul_h(result, l_all)


# ---------------------------------------------------------------------------
# domain schedule helpers (utils.rs:167-186)
# ---------------------------------------------------------------------------
def next_domain_shift(F, current_shift, log_arity):
    """shift^(2^k) · GENERATOR — disjoint coset of the next domain."""
    return F.mul_h(F.exp_h(current_shift, 1 << log_arity), F.GENERATOR)


def fold_domain_params(F, current_shift, current_log_domain, log_arity):
    """(log_size, shift) of the raw fold domain: shift^(2^k) · H."""
    return (
        current_log_domain - log_arity,
        F.exp_h(current_shift, 1 << log_arity),
    )


def sample_ood_points(E, challenger, excluded_domains, num_ood_samples):
    """Distinct OOD points outside all excluded (shift, log_size) cosets
    (utils.rs:196). Both sides derive identical points."""
    F = E.base
    ood = []
    while len(ood) < num_ood_samples:
        z = challenger.sample_ext(E.D)
        outside = True
        for shift, log_size in excluded_domains:
            zn = E.base_mul_h(F.inv_h(shift), z)
            if log_size != 0 and E.exp_h(zn, 1 << log_size) == E.one_h():
                outside = False
                break
        if outside and z not in ood:
            ood.append(z)
    return ood


# ---------------------------------------------------------------------------
# codeword-sized ops ((N, D) int64 Montgomery tensors)
# ---------------------------------------------------------------------------
def fold_codeword(E, codeword, beta, log_arity, log_domain_size):
    """Arity-2^k fold as k arity-2 passes (utils.rs:398): per pass
    fold(j) = (lo+hi)/2 + (beta/2)·g^{-j}·(lo−hi), beta squaring between
    passes. codeword: (N, D) Montgomery tensor; beta: ext tuple (std)."""
    F = E.base
    data = codeword
    cur_beta = beta
    cur_log = log_domain_size
    half = F.inv_h(2)
    for _ in range(log_arity):
        h = data.shape[0] // 2
        lo, hi = data[:h], data[h:]
        g_inv = F.inv_h(F.two_adic_generator_h(cur_log))
        hip = powers_device(F, g_inv, h, data.device, scale_std=half)
        term = E.base_mul(hip, E.mul(E.sub(lo, hi),
                                     E.const(cur_beta, data.device)))
        data = E.add(F.mul(E.add(lo, hi), F.to_monty_h(half)), term)
        cur_beta = E.mul_h(cur_beta, cur_beta)
        cur_log -= 1
    return data


def fold_fiber(E, fiber, j, log_new_height, log_arity, beta):
    """Expected folded value for one fiber (verifier side, utils.rs:455):
    Lagrange interpolation over subgroup x-coords at beta."""
    F = E.base
    arity = 1 << log_arity
    if len(fiber) != arity:
        raise ValueError(f"a fiber of {len(fiber)} values, not {arity}")
    new_height = 1 << log_new_height
    g = F.two_adic_generator_h(log_new_height + log_arity)
    x0 = F.exp_h(g, j)
    step = F.exp_h(g, new_height)
    xs = []
    x = x0
    for _ in range(arity):
        xs.append(x)
        x = F.mul_h(x, step)
    return lagrange_eval_at(E, xs, fiber, beta)


def codeword_from_coeffs(E, coeffs, shift, log_domain):
    """Evaluate ext coefficients ((m, D) Montgomery tensor) on shift·K,
    |K| = 2^log_domain, natural order. The extension is an F-linear
    space, so the D component transforms are the extension's transform:
    one base-field NTT of D columns."""
    F = E.base
    added = log_domain - log2_strict(coeffs.shape[0])
    out_br = coset_evals_from_coeffs(F, coeffs, added, shift)
    return bitrev_permute_axis0(out_br, log_domain)


def coeffs_from_codeword(E, codeword, shift):
    """Interpolate a natural-order codeword on shift·H back to
    coefficients: the inverse DFT, then scale by shift^{-i}."""
    F = E.base
    n = codeword.shape[0]
    coeffs = idft(F, codeword)
    sp = powers_device(F, F.inv_h(shift), n, codeword.device)
    return E.base_mul(sp, coeffs)


def eval_coeffs_at_ext_point(E, coeffs, z):
    """Σ c_i z^i for (n, D) Montgomery coefficients at a host ext point
    z (std tuple), on the coefficients' device; a host tuple out."""
    n = coeffs.shape[0]
    if n == 0:
        return E.zero_h()
    zpow = _ext_powers_device(E, E.const(z, coeffs.device),
                              (n - 1).bit_length())
    prods = E.mul(coeffs, zpow[:n])
    acc = E.base.sum(prods, dim=0).cpu().numpy()
    return E.from_monty_np(acc)
