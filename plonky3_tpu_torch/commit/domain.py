"""Two-adic multiplicative coset domains (PolynomialSpace).

Port of `plonky3_tpu/commit/domain.py` (commit/src/domain.rs:54,
field/src/coset.rs:55): the coset shift·H for the two-adic subgroup H of
size 2^log_n. The host methods take exact ints and extension tuples (the
verifier's side); the device method gives the prover's selector tensors.

  vanishing  Z_{gH}(X) = (X/g)^|H| - 1
  selectors: first = Z/(X/g - 1), last = Z/(X/g - h^-1),
             transition = X/g - h^-1, inv_vanishing = 1/Z
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.ntt import powers_device


@dataclass(frozen=True)
class TwoAdicCoset:
    F: object
    shift: int  # standard form
    log_n: int

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def gen(self) -> int:
        """Generator h of the subgroup H."""
        return self.F.two_adic_generator_h(self.log_n)

    def first_point(self) -> int:
        return self.shift

    def next_point_ext(self, E, x):
        """x -> h·x for an extension point x (host tuple)."""
        return E.base_mul_h(self.gen, x)

    def create_disjoint_domain(self, min_size: int) -> "TwoAdicCoset":
        """The coset shift·GENERATOR·K, |K| = next_pow2(min_size)."""
        log_k = (min_size - 1).bit_length()
        if log_k > self.F.TWO_ADICITY:
            raise ValueError("min_size exceeds the two-adicity")
        return TwoAdicCoset(self.F, self.F.mul_h(self.shift,
                                                 self.F.GENERATOR), log_k)

    def split_domains(self, num_chunks: int) -> list:
        """gH -> [gK, ghK, gh^2 K, ...] with K = H^num_chunks."""
        log_c = num_chunks.bit_length() - 1
        if 1 << log_c != num_chunks or log_c > self.log_n:
            raise ValueError(f"cannot split into {num_chunks} chunks")
        h = self.gen
        return [
            TwoAdicCoset(self.F, self.F.mul_h(self.shift, self.F.exp_h(h, i)),
                         self.log_n - log_c)
            for i in range(num_chunks)
        ]

    def split_evals(self, num_chunks: int, evals):
        """Row i of chunk c is row i·num_chunks + c of `evals` (natural
        order)."""
        return [evals[c::num_chunks] for c in range(num_chunks)]

    # ---- host (verifier) values at one point --------------------------
    def vanishing_poly_at_point_h(self, x: int) -> int:
        """Z(x) for a base-field point (standard form)."""
        F = self.F
        return (F.exp_h(F.mul_h(F.inv_h(self.shift), x), self.size)
                - 1) % F.P

    def vanishing_poly_at_point_ext(self, E, point):
        sp = E.base_mul_h(self.F.inv_h(self.shift), point)
        return E.sub_h(E.exp_h(sp, self.size), E.one_h())

    def selectors_at_point_ext(self, E, point):
        sp = E.base_mul_h(self.F.inv_h(self.shift), point)
        z_h = E.sub_h(E.exp_h(sp, self.size), E.one_h())
        last_den = E.sub_h(sp, E.from_base_h(self.F.inv_h(self.gen)))
        return dict(
            is_first_row=E.mul_h(z_h, E.inv_h(E.sub_h(sp, E.one_h()))),
            is_last_row=E.mul_h(z_h, E.inv_h(last_den)),
            is_transition=last_den,
            inv_vanishing=E.inv_h(z_h),
        )

    # ---- device selectors over a disjoint coset (prover) ---------------
    def selectors_on_coset_device(self, coset: "TwoAdicCoset", device):
        """Selector tensors at every point of `coset`, natural order
        (domain.rs selectors_on_coset; needs self.shift == 1)."""
        F = self.F
        if self.shift != 1 or coset.shift == 1 or coset.log_n < self.log_n:
            raise ValueError("selectors need H and a disjoint larger coset")
        rate_bits = coset.log_n - self.log_n
        n = self.size
        xs = powers_device(F, coset.gen, coset.size, device,
                           scale_std=coset.shift)
        # Z_H(x_i) = s^n·g_N^{i·n} - 1 repeats with period 2^rate_bits
        zh_period = F.sub(powers_device(
            F, F.two_adic_generator_h(rate_bits), 1 << rate_bits, device,
            scale_std=F.exp_h(coset.shift, n)), F.const(1))
        zh = zh_period.repeat(n)
        inv_vanishing = F.inv(zh_period).repeat(n)
        last_den = F.sub(xs, F.const(F.inv_h(self.gen)))
        return dict(
            is_first_row=F.mul(zh, F.inv(F.sub(xs, F.const(1)))),
            is_last_row=F.mul(zh, F.inv(last_den)),
            is_transition=last_den,
            inv_vanishing=inv_vanishing,
        )
