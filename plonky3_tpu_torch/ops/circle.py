"""The circle-group FFT of Mersenne-31 (the CFFT of `circle/src/cfft.rs`).

Port of `plonky3_tpu/ops/circle.py`. M31 is not two-adic; its FFT domain
is the unit circle x^2 + y^2 = 1. A `CircleDomain(log_n, shift)` is the
twin coset {shift + k·g} ∪ {-shift + (k+1)·g}, g = generator(log_n - 1),
interleaved (domain.rs:43-93). Values live in "cfft order": natural index
i maps to cfft row `cfft_permute_index(i)` (ordering.rs:9, an involution).

Transforms (cfft.rs):
  interpolate: DIF butterfly layers with inverted twiddles: layer 0 the
    y-coordinates of bitrev(coset0), layer 1 the x-coordinates (every
    second), layer i >= 2 repeated x -> 2x^2 - 1; then scale by 1/n. A
    layer with b twiddles pairs rows j, j ^ (n/(2b)) sharing twiddle
    ts[b·j/n] (cfft.rs:274-280).
  evaluate: tile the coefficients 2^added times (the reference's
    zero-padding by duplication, cfft.rs:195-205), then DIT layers with
    b = 2^added .. n/2.

The reference's transforms are jnp, not Pallas, so here they are plain
torch on canonical int64 tensors. Every column transforms on its own, so
a matrix goes through in blocks of columns (`_col_block`), which bounds
the temporaries and gives the bits of the whole matrix. The host tables
(points, twiddles, selectors) are computed once and kept per domain and
device.

Coefficient basis (cfft.rs circle_basis): index bit 0 = y, bit k >= 1 =
π^{k-1}(x) where π(x) = 2x^2 - 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.mersenne31 import CIRCLE_TWO_ADIC_GENERATORS
from ..fields.mersenne31 import Mersenne31 as F
from ..utils.bits import bitrev_indices, log2_strict

_P = F.P
_P64 = np.uint64(_P)

# the bytes of one column block's output (its temporaries are a few
# times this)
_BLOCK_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# host points: (x, y) tuples of canonical ints
# ---------------------------------------------------------------------------
def pt_add(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % _P,
            (a[0] * b[1] + a[1] * b[0]) % _P)


def pt_neg(a):
    return (a[0], (-a[1]) % _P)


def pt_sub(a, b):
    return pt_add(a, pt_neg(b))


def pt_double(a):
    return ((2 * a[0] * a[0] - 1) % _P, (2 * a[0] * a[1]) % _P)


def pt_mul(a, k: int):
    acc, cur = (1, 0), a
    while k:
        if k & 1:
            acc = pt_add(acc, cur)
        cur = pt_double(cur)
        k >>= 1
    return acc


def pt_generator(i: int):
    """Generator of the order-2^i circle subgroup (complex.rs:16)."""
    return CIRCLE_TWO_ADIC_GENERATORS[i]


def pt_v_n(x: int, log_n: int) -> int:
    """v_n of a point given its x coordinate (point.rs:77)."""
    for _ in range(log_n - 1):
        x = (2 * x * x - 1) % _P
    return x


def cfft_permute_index(index: int, log_n: int) -> int:
    """ordering.rs:9 (an involution)."""
    idx, lsb = index >> 1, index & 1
    if lsb:
        idx = (1 << log_n) - idx - 1
    r = 0
    for _ in range(log_n):
        r = (r << 1) | (idx & 1)
        idx >>= 1
    return r


def cfft_perm_indices(log_n: int) -> np.ndarray:
    """[cfft_permute_index(i, log_n) for every i], vectorized: int64."""
    i = np.arange(1 << log_n, dtype=np.int64)
    idx = np.where(i & 1, (1 << log_n) - (i >> 1) - 1, i >> 1)
    return bitrev_indices(log_n)[idx]


def _pow_np(a: np.ndarray, e: int) -> np.ndarray:
    acc = np.ones_like(a, dtype=np.uint64)
    base = np.asarray(a, dtype=np.uint64) % _P64
    while e:
        if e & 1:
            acc = acc * base % _P64
        base = base * base % _P64
        e >>= 1
    return acc


def _points_np(shift, gen, count: int):
    """shift + k·gen for k < count as two uint64 arrays, by doubling."""
    xs = np.array([shift[0]], np.uint64)
    ys = np.array([shift[1]], np.uint64)
    step = gen
    while xs.shape[0] < count:
        sx, sy = np.uint64(step[0]), np.uint64(step[1])
        nx = (xs * sx % _P64 + _P64 - ys * sy % _P64) % _P64
        ny = (xs * sy % _P64 + ys * sx % _P64) % _P64
        xs, ys = np.concatenate([xs, nx]), np.concatenate([ys, ny])
        step = pt_double(step)
    return xs[:count], ys[:count]


class CircleDomain:
    """Twin coset of size 2^log_n with a host shift point; hashable by
    value."""

    def __init__(self, log_n: int, shift):
        self.log_n = log_n
        self.shift = tuple(int(c) for c in shift)

    def __eq__(self, other):
        return (isinstance(other, CircleDomain) and self.log_n == other.log_n
                and self.shift == other.shift)

    def __hash__(self):
        return hash((self.log_n, self.shift))

    def __repr__(self):
        return f"CircleDomain({self.log_n}, {self.shift})"

    @staticmethod
    def standard(log_n: int) -> "CircleDomain":
        return CircleDomain(log_n, pt_generator(log_n + 1))

    @property
    def size(self):
        return 1 << self.log_n

    def subgroup_generator(self):
        return pt_generator(self.log_n - 1)

    def coset0_points(self):
        g, p, out = self.subgroup_generator(), self.shift, []
        for _ in range(1 << (self.log_n - 1)):
            out.append(p)
            p = pt_add(p, g)
        return out

    def coset0_np(self):
        """coset0's points as two uint64 arrays."""
        return _points_np(self.shift, self.subgroup_generator(),
                          1 << (self.log_n - 1))

    def points_natural_np(self):
        """All 2^log_n points in natural (interleaved) order
        (domain.rs:73): two uint64 arrays."""
        g = self.subgroup_generator()
        half = 1 << (self.log_n - 1)
        x0, y0 = _points_np(self.shift, g, half)
        x1, y1 = _points_np(pt_sub(g, self.shift), g, half)
        return (np.stack([x0, x1], axis=1).reshape(-1),
                np.stack([y0, y1], axis=1).reshape(-1))

    def points_natural(self):
        xs, ys = self.points_natural_np()
        return [(int(x), int(y)) for x, y in zip(xs, ys)]

    def nth_point(self, idx: int):
        i, lsb = idx >> 1, idx & 1
        g = self.subgroup_generator()
        if lsb == 0:
            return pt_add(self.shift, pt_mul(g, i))
        return pt_add(pt_neg(self.shift), pt_mul(g, i + 1))

    # ---- the PolynomialSpace surface (domain.rs:150-366) --------------------
    def is_standard(self):
        return self.shift == pt_generator(self.log_n + 1)

    def first_point(self) -> int:
        """shift.to_projective_line() = y / (x + 1) (domain.rs:152)."""
        return (self.shift[1] * pow(self.shift[0] + 1, _P - 2, _P)) % _P

    def create_disjoint_domain(self, min_size: int) -> "CircleDomain":
        if not self.is_standard():
            raise ValueError("a disjoint domain needs a standard domain")
        log_k = (min_size - 1).bit_length()
        if log_k == self.log_n:
            log_k += 1
        return CircleDomain.standard(log_k)

    def split_domains(self, num_chunks: int) -> list:
        if not self.is_standard():
            raise ValueError("splitting needs a standard domain")
        log_c = num_chunks.bit_length() - 1
        if 1 << log_c != num_chunks or log_c > self.log_n:
            raise ValueError(f"cannot split into {num_chunks} chunks")
        xs, ys = self.points_natural_np()
        return [CircleDomain(self.log_n - log_c, (int(xs[c]), int(ys[c])))
                for c in range(num_chunks)]

    def split_evals(self, num_chunks: int, evals):
        """Forward-backward interleave (domain.rs:196-213, 363): row i
        goes to chunk fb(i), fb repeating 0 1 .. k-1 k-1 .. 1 0."""
        n, k = evals.shape[0], num_chunks
        if n % (2 * k):
            raise ValueError(f"{n} rows do not split into {k} chunks")
        blocks = evals.reshape((n // (2 * k), 2 * k) + tuple(evals.shape[1:]))
        return [torch.stack([blocks[:, c], blocks[:, 2 * k - 1 - c]], dim=1)
                .reshape((n // k,) + tuple(evals.shape[1:]))
                for c in range(k)]

    # ---- host (verifier) values at an extension point -----------------------
    def next_point_ext(self, E, t):
        """Projective-line coordinate of point(t) + generator(log_n)."""
        p = ept_from_projective_line(E, t)
        g = pt_generator(self.log_n)
        x = E.sub_h(E.base_mul_h(g[0], p[0]), E.base_mul_h(g[1], p[1]))
        y = E.add_h(E.base_mul_h(g[1], p[0]), E.base_mul_h(g[0], p[1]))
        return E.mul_h(y, E.inv_h(E.add_h(x, E.one_h())))

    def vanishing_poly_at_point_ext(self, E, t):
        p = ept_from_projective_line(E, t)
        return E.sub_h(ept_v_n(E, p[0], self.log_n),
                       E.from_base_h(pt_v_n(self.shift[0], self.log_n)))

    def selectors_at_point_ext(self, E, t):
        """LagrangeSelectors at an extension point (domain.rs:219-246)."""
        at = ept_from_projective_line(E, t)
        neg_shift = pt_neg(self.shift)
        k = _s_p_at_p_host(neg_shift, self.log_n)
        z = E.sub_h(ept_v_n(E, at[0], self.log_n),
                    E.from_base_h(pt_v_n(self.shift[0], self.log_n)))
        den_shift = _v_tilde_p_ext(E, self.shift, at)
        den_negshift_k = E.base_mul_h(k, _v_tilde_p_ext(E, neg_shift, at))
        z_inv_dk = E.mul_h(z, E.inv_h(den_negshift_k))
        return dict(
            is_first_row=E.mul_h(z, E.inv_h(den_shift)),
            is_last_row=E.base_mul_h(k, z_inv_dk),
            is_transition=E.sub_h(E.one_h(), z_inv_dk),
            inv_vanishing=E.inv_h(z),
        )

    # ---- device (prover) selectors over a disjoint standard coset ----------
    def selectors_on_coset_device(self, coset: "CircleDomain", device):
        """The selector tensors at every point of `coset`, natural order
        (domain.rs:262-320), kept per domain, coset and device."""
        key = (self.log_n, self.shift, coset.log_n, coset.shift, str(device))
        out = _SELECTOR_CACHE.get(key)
        if out is None:
            out = {k: torch.from_numpy(v.astype(np.int64)).to(device)
                   for k, v in _selectors_on_coset_np(
                       self.log_n, self.shift, coset).items()}
            _SELECTOR_CACHE[key] = out
        return out


def _s_p_at_p_host(p, log_n: int) -> int:
    """point.rs:110: -(v_n_prod(log_n)·2^(2·log_n - 1))·y."""
    x = p[0]
    if log_n >= 2:
        out = x
        for _ in range(log_n - 2):
            x = (2 * x * x - 1) % _P
            out = (out * x) % _P
    else:
        out = 1
    return (-(out * pow(2, 2 * log_n - 1, _P)) * p[1]) % _P


def _v_tilde_p_ext(E, p, at):
    """(at - p).to_projective_line() (point.rs:105)."""
    dx = E.add_h(E.base_mul_h(p[0], at[0]), E.base_mul_h(p[1], at[1]))
    dy = E.sub_h(E.base_mul_h(p[0], at[1]), E.base_mul_h(p[1], at[0]))
    return E.mul_h(dy, E.inv_h(E.add_h(dx, E.one_h())))


def ept_from_projective_line(E, t):
    """Point::from_projective_line (point.rs:40) over the extension."""
    t2 = E.mul_h(t, t)
    inv_denom = E.inv_h(E.add_h(E.one_h(), t2))
    return (E.mul_h(E.sub_h(E.one_h(), t2), inv_denom),
            E.mul_h(E.add_h(t, t), inv_denom))


def ept_v_n(E, x, log_n: int):
    for _ in range(log_n - 1):
        xx = E.mul_h(x, x)
        x = E.sub_h(E.add_h(xx, xx), E.one_h())
    return x


_SELECTOR_CACHE: dict = {}


def _selectors_on_coset_np(log_n, shift, coset: CircleDomain):
    """selectors_on_coset (domain.rs:262-320), vectorized: uint64."""
    ax, ay = coset.points_natural_np()
    x = ax.copy()
    for _ in range(log_n - 1):
        x = (2 * x * x % _P64 + _P64 - 1) % _P64
    z = (x + _P64 - np.uint64(pt_v_n(shift[0], log_n))) % _P64

    def v_tilde(p):
        px, py = np.uint64(p[0]), np.uint64(p[1])
        dx = (px * ax % _P64 + py * ay % _P64) % _P64
        dy = (px * ay % _P64 + (_P64 - py) * ax % _P64) % _P64
        return dy * _pow_np((dx + np.uint64(1)) % _P64, _P - 2) % _P64

    neg_shift = pt_neg(shift)
    k = np.uint64(_s_p_at_p_host(neg_shift, log_n))
    den_shift = v_tilde(shift)
    den_negshift_k = v_tilde(neg_shift) * k % _P64
    z_inv_dk = z * _pow_np(den_negshift_k, _P - 2) % _P64
    return dict(
        is_first_row=z * _pow_np(den_shift, _P - 2) % _P64,
        is_last_row=z_inv_dk * k % _P64,
        is_transition=(np.uint64(1) + _P64 - z_inv_dk) % _P64,
        inv_vanishing=_pow_np(z, _P - 2),
    )


# ---------------------------------------------------------------------------
# twiddles (host precompute, kept per domain and device)
# ---------------------------------------------------------------------------
_TWIDDLES: dict = {}


def twiddles_np(domain: CircleDomain):
    """Per-layer twiddles [y (n/2), x (n/4), 2x^2 - 1 (n/8), ...]
    (cfft.rs:553) as uint64 arrays."""
    xs, ys = domain.coset0_np()
    br = bitrev_indices(domain.log_n - 1)
    xs, ys = xs[br], ys[br]
    layers = [ys]
    if domain.log_n >= 2:
        layers.append(xs[::2])
        for _ in range(domain.log_n - 2):
            prev = layers[-1][::2]
            layers.append((2 * prev * prev % _P64 + _P64 - 1) % _P64)
    return layers


def _twiddles(domain: CircleDomain, inverse: bool, device):
    """The layers of `twiddles_np` (inverted for the interpolation) as
    int64 tensors on `device`."""
    key = (domain.log_n, domain.shift, inverse, str(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        tw = [torch.from_numpy((_pow_np(t, _P - 2) if inverse else t)
                               .astype(np.int64)).to(device)
              for t in twiddles_np(domain)]
        _TWIDDLES[key] = tw
    return tw


_PERMS: dict = {}


def cfft_perm_device(log_n: int, device):
    """`cfft_perm_indices` as an int64 tensor on `device`, kept."""
    key = (log_n, str(device))
    p = _PERMS.get(key)
    if p is None:
        p = _PERMS[key] = torch.from_numpy(cfft_perm_indices(log_n)).to(
            device)
    return p


# ---------------------------------------------------------------------------
# transforms (values in cfft order along axis 0)
# ---------------------------------------------------------------------------
def _butterfly_layer(x, tw, dif: bool):
    """One layer in place on (n, w): b = len(tw) twiddles, blocks of
    n/b rows whose halves pair up."""
    n, b = x.shape[0], tw.shape[0]
    v = x.view(b, 2, n // (2 * b), x.shape[1])
    lo, hi = v[:, 0], v[:, 1]
    t = tw.view(b, 1, 1)
    if dif:  # (lo + hi, (lo - hi)·t)
        d = F.sub(lo, hi) * t % _P
        lo.copy_(F.add(lo, hi))
        hi.copy_(d)
    else:  # (lo + hi·t, lo - hi·t)
        ht = hi * t % _P
        hi.copy_(F.sub(lo, ht))
        lo.copy_(F.add(lo, ht))


def _col_block(rows: int) -> int:
    return max(1, _BLOCK_BYTES // (8 * rows))


def cfft_interpolate(domain: CircleDomain, values_cfft):
    """(n, w) cfft-order evaluations -> (n, w) coefficients."""
    n, w = values_cfft.shape
    if n != domain.size:
        raise ValueError(f"{n} rows for a domain of {domain.size}")
    tws = _twiddles(domain, True, values_cfft.device)
    n_inv = pow(n, _P - 2, _P)
    out = torch.empty((n, w), dtype=torch.int64, device=values_cfft.device)
    step = _col_block(n)
    for c in range(0, w, step):
        # a copy: the butterflies work in place
        x = values_cfft[:, c:c + step].clone(
            memory_format=torch.contiguous_format)
        for tw in tws:
            _butterfly_layer(x, tw, dif=True)
        out[:, c:c + step] = x * n_inv % _P
    return out


def cfft_evaluate(domain: CircleDomain, coeffs):
    """(m, w) coefficients -> (n, w) cfft-order evaluations on `domain`
    (m <= n = domain.size; the zero-padding by row duplication)."""
    m, w = coeffs.shape
    added = domain.log_n - log2_strict(m)
    if added < 0:
        raise ValueError(f"{m} coefficients for a domain of {domain.size}")
    tws = _twiddles(domain, False, coeffs.device)[::-1][added:]
    n = domain.size
    out = torch.empty((n, w), dtype=torch.int64, device=coeffs.device)
    step = _col_block(n)
    for c in range(0, w, step):
        x = coeffs[:, c:c + step].repeat(1 << added, 1)
        for tw in tws:
            _butterfly_layer(x, tw, dif=False)
        out[:, c:c + step] = x
        del x
    return out


def circle_basis_host(point, log_n: int):
    """[basis_i(point)] in coefficient order (cfft.rs:575)."""
    b = [1, point[1]]
    x = point[0]
    for _ in range(log_n - 1):
        b.extend([(v * x) % _P for v in b])
        x = (2 * x * x - 1) % _P
    return b
