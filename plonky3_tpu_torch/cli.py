"""The port's command line: `prove`, as `plonky3_tpu/cli.py` has it (the
`examples/examples/prove_prime_field_31.rs` analog, :51-73 flag matrix).

    python -m plonky3_tpu_torch.cli prove --field baby-bear \
        --objective poseidon-2-permutations --log-trace-length 17 \
        --fri benchmark-high-arity --merkle-hash keccak-f --prover fast

It takes the reference's flags and defaults, and `--device` (default
`cuda`; `--device cpu` runs the kernels' plain versions). With no CUDA
device and no `--device cpu` it exits with an error. It prints what the
reference prints: the objective line, the spans (trace generation, each
prove and its stages, the host verify), the proof size and the soundness
bits. `build` makes the (config, AIR, trace, public values) of a run and
`run` proves, verifies and reports it; `chip_smoke.py` proves through
`build` what this command proves.

`--field mersenne-31` proves under `circle_stark_config` (the circle PCS
over QM31, the KeccakF Merkle tree, SerializingChallenger32), whatever
`--merkle-hash` says, as the reference does; its FRI must fold by 2
(`--fri testing` or `benchmark`). The device-transcript prover covers the
two-adic PCS only, so a circle run proves with `prove()` and says so.
`poseidon-2-permutations` over Mersenne-31 fails as the reference's does:
there are no Poseidon2 constants for it.

`pcs-comparison` commits one random matrix with FRI, STIR and WHIR (the
last as one stacked MLE), opens it at one point and verifies, and prints
each scheme's commit+open and verify milliseconds and proof bytes, then
WHIR's soundness line (the reference's arguments and lines,
plonky3_tpu/cli.py:213-332):

    python -m plonky3_tpu_torch.cli pcs-comparison --log-trace-length 18 \
        --width 16 --fri benchmark --security-level 100 --max-pow-bits 20

(At 2^18 rows with 12 or 16 PoW bits STIR's schedule, the reference's,
refuses the degree: `stir/config.py` raises where the reference asserts.)
"""

from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass

import numpy as np

FIELDS = ("koala-bear", "baby-bear", "mersenne-31")
OBJECTIVES = ("poseidon-2-permutations", "fibonacci", "keccak-f-permutations",
              "blake3-permutations")
FRIS = ("testing", "benchmark", "benchmark-high-arity")
MERKLE_HASHES = ("poseidon2", "keccak-f")
PROVERS = ("host", "fast")


def field_pair(name):
    """(base field, degree-4 extension) of a `--field` value."""
    from .fields import BabyBear, BabyBearExt4, KoalaBear, KoalaBearExt4
    from .fields.mersenne31 import Mersenne31
    from .fields.qm31 import QM31

    return {"koala-bear": (KoalaBear, KoalaBearExt4),
            "baby-bear": (BabyBear, BabyBearExt4),
            "mersenne-31": (Mersenne31, QM31)}[name]



def fri_params(name):
    from .fri.config import FriParameters

    return {"testing": FriParameters.new_testing,
            "benchmark": FriParameters.new_benchmark,
            "benchmark-high-arity":
                FriParameters.new_benchmark_high_arity}[name]()


class Spans:
    """The reference's span list (a tracing-forest analog): (name,
    seconds) rows in order; a nested row's name starts with two spaces. A
    span on a CUDA device waits for the device at its end."""

    def __init__(self, device=None):
        self.rows = []
        self.device = device

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.rows.append((name, time.perf_counter() - t0))

    def report(self):
        total = sum(t for n, t in self.rows if not n.startswith("  "))
        for name, t in self.rows:
            print(f"  {name:<28s} {t*1e3:10.1f} ms")
        print(f"  {'TOTAL':<28s} {total*1e3:10.1f} ms")
        return total


@dataclass
class Job:
    """What `build` makes: a proof's inputs and the line that names them."""

    config: object
    air: object
    trace: object
    publics: list
    log_n: int
    objective: str  # the reference's objective line ("" for fibonacci)


def build(field="koala-bear", objective="poseidon-2-permutations",
          log_trace_length=10, log_vector_len=3, fri="benchmark-high-arity",
          merkle_hash="poseidon2", device=None, spans=None) -> Job:
    """The config, AIR, trace and public values of one `prove` run, on
    `device` (default cuda), the inputs from np.random.default_rng(1) as
    the reference makes them (plonky3_tpu/cli.py:108-156). Trace
    generation is timed into `spans` (a `Spans`) when given."""
    from . import default_device
    from .compat import trace_inputs_from_numpy
    from .stark.config import (circle_stark_config, keccak_stark_config,
                               poseidon2_stark_config)

    dev = default_device(device)
    F, E = field_pair(field)
    if field == "mersenne-31":
        fp = fri_params(fri)
        if fp.max_log_arity != 1:
            raise ValueError("circle FRI folds by 2: use --fri testing or "
                             "benchmark")
        config = circle_stark_config(fp, device=dev)
    else:
        make_config = {"poseidon2": poseidon2_stark_config,
                       "keccak-f": keccak_stark_config}[merkle_hash]
        config = make_config(F, E, fri_params(fri), device=dev)
    spans = spans or Spans(dev)
    log_n = log_trace_length
    rng = np.random.default_rng(1)
    publics, line = [], ""
    if objective == "poseidon-2-permutations":
        from .models.poseidon2_air import (Poseidon2VectorAir,
                                           generate_vectorized_trace)

        vector_len = 1 << log_vector_len
        air = Poseidon2VectorAir(F, 16, vector_len=vector_len)
        n_perms = vector_len << log_n
        inputs = trace_inputs_from_numpy(F.rand_np(rng, (n_perms, 16)), dev)
        with spans.span("generate trace (device)"):
            trace, _ = generate_vectorized_trace(air, inputs, device=dev)
        line = (f"objective: {n_perms} Poseidon2-16 permutations "
                f"({vector_len}/row x 2^{log_n} rows, width {air.width})")
    elif objective == "keccak-f-permutations":
        from .models.keccak_air import KeccakAir, generate_keccak_trace

        air = KeccakAir(F)
        n_perms = max((1 << log_n) // 24, 1)
        inputs = rng.integers(0, 1 << 64, size=(n_perms, 25),
                              dtype=np.uint64)
        with spans.span("generate trace (host)"):
            trace = generate_keccak_trace(F, inputs, device=dev)
        line = (f"objective: {n_perms} keccak-f[1600] permutations "
                f"(24 rows each, width {air.width})")
    elif objective == "blake3-permutations":
        from .models.blake3_air import Blake3Air, generate_blake3_trace

        air = Blake3Air(F)
        n_perms = 1 << log_n
        inputs = rng.integers(0, 1 << 32, size=(n_perms, 24),
                              dtype=np.uint64).astype(np.uint32)
        with spans.span("generate trace (host)"):
            trace = generate_blake3_trace(F, inputs, device=dev)
        line = (f"objective: {n_perms} blake3 compressions "
                f"(1 row each, width {air.width})")
    elif objective == "fibonacci":
        from .models.fibonacci import FibonacciAir, generate_fibonacci_trace

        air = FibonacciAir(F)
        with spans.span("generate trace (host)"):
            trace, publics = generate_fibonacci_trace(F, log_n, device=dev)
    else:
        raise ValueError(f"unknown objective {objective}")
    return Job(config, air, trace, publics, log_n, line)


def soundness_bits(config, air, log_n):
    """(conjectured, proven) soundness bits of a proof, as the reference's
    report computes them (cli.py:179-206)."""
    from .air.api import get_symbolic_layout
    from .stark.security import (FriRegime, InstanceShape, StarkAirParams,
                                 conjectured_security, proven_security)

    fp = config.pcs.fri
    n_cons, max_deg = get_symbolic_layout(air)
    regime = FriRegime(
        log_blowup=fp.log_blowup, num_queries=fp.num_queries,
        log_final_poly_len=fp.log_final_poly_len,
        max_log_arity=fp.max_log_arity,
        commit_pow_bits=fp.commit_proof_of_work_bits,
        query_pow_bits=fp.query_proof_of_work_bits)
    shape = InstanceShape(log_trace_length=log_n,
                          modulus_bits=31.0 * config.E.D,
                          collision_resistance=128.0)
    air_params = StarkAirParams(num_constraints=n_cons,
                                max_constraint_degree=max_deg, max_combo=2)
    return (conjectured_security(regime, shape),
            proven_security(regime, air_params, shape))


def chosen_prover(config, prover="host") -> str:
    """The prover a run takes: `fast` (the device transcript) covers the
    two-adic PCS only, so a circle config proves with `host`."""
    from .circle_pcs import CirclePcs

    return "host" if isinstance(config.pcs, CirclePcs) else prover


def run(job: Job, prover="host", repeat=1, spans=None):
    """Prove `job` `repeat` times with the host-transcript prover
    (`host`) or the device-transcript one (`fast`; `chosen_prover`),
    verify the last proof on the host, and print the report. Returns the
    proof."""
    from .stark.verifier import verify

    chosen = chosen_prover(job.config, prover)
    if chosen == "fast":
        from .stark.fast_prover import prove_fast as prove
    else:
        from .stark.prover import prove
    spans = spans or Spans(job.config.device)
    if job.objective:
        print(job.objective)
    if chosen != prover:
        print(f"prover: {chosen} (prove(); the device-transcript prover "
              f"covers the two-adic PCS only)")
    else:
        print(f"prover: {chosen}")
    for rep in range(repeat):
        phase = {}
        with spans.span(f"prove (total, run {rep})"):
            proof = prove(job.config, job.air, job.trace, job.publics,
                          spans=phase)
        spans.rows.extend((f"  prove: {k}", v) for k, v in phase.items())
    with spans.span("verify (host)"):
        verify(job.config, job.air, proof, job.publics)
    spans.report()
    print(f"  proof size: {proof.size_in_bytes()} bytes")
    conj, proven = soundness_bits(job.config, job.air, job.log_n)
    print(f"  soundness: {conj:.1f} bits conjectured, {proven:.1f} proven")
    return proof


def cmd_prove(args):
    dev = _device_or_exit(args.device)
    spans = Spans(dev)
    job = build(args.field, args.objective, args.log_trace_length,
                args.log_vector_len, args.fri, args.merkle_hash, dev, spans)
    return run(job, args.prover, args.repeat, spans)


def _device_or_exit(name):
    from . import default_device

    try:
        return default_device(name)
    except RuntimeError:
        raise SystemExit("plonky3_tpu_torch.cli: no CUDA device is "
                         "available; pass --device cpu to run the kernels' "
                         "plain versions on the CPU") from None


def proof_bytes(proof):
    """Wire-size estimate: 4 bytes a base element over any proof tree."""
    if isinstance(proof, (list, tuple)):
        return sum(proof_bytes(v) for v in proof)
    if isinstance(proof, dict):
        return sum(proof_bytes(v) for v in proof.values())
    if hasattr(proof, "__dict__"):
        return proof_bytes(vars(proof))
    if isinstance(proof, (int, np.integer)):
        return 4
    return 0


@dataclass
class PcsJob:
    """What `pcs_job` makes: one random matrix, its opening point and the
    three PCSs of a `pcs-comparison` run."""

    F: object
    E: object
    log_n: int
    width: int
    evals: object  # (2^log_n, width) Montgomery tensor on the device
    z: tuple  # the univariate opening point
    n_vars: int  # the stacked MLE's variables
    stacked: object  # (2^n_vars,) standard-form tensor: the columns, padded
    point: list  # the multilinear opening point
    pcs: dict  # "fri", "stir", "whir"
    challenger: object  # () -> a fresh DuplexChallenger(perm24, rate 16)


def pcs_job(field="koala-bear", log_trace_length=10, width=8,
            fri="testing", log_blowup=2, log_folding_factor=2,
            security_level=60, max_pow_bits=12, device=None) -> PcsJob:
    """The PCSs, matrix and points of a `pcs-comparison` run, on `device`
    (default cuda), the inputs from np.random.default_rng(3) as the
    reference draws them (plonky3_tpu/cli.py:265-325). WHIR's schedule
    comes from a security assumption (whir.rs:220)."""
    import torch

    from . import default_device
    from .challenger.duplex import DuplexChallenger
    from .fri.two_adic_pcs import TwoAdicFriPcs
    from .hashes.poseidon2 import default_poseidon2
    from .hashes.sponge import PaddingFreeSponge, TruncatedPermutation
    from .merkle.extension_mmcs import ExtensionMmcs
    from .merkle.mmcs import MerkleTreeMmcs
    from .multilinear.whir import WhirConfig, WhirPcs
    from .stir import StirParameters
    from .stir.pcs import TwoAdicStirPcs

    dev = default_device(device)
    F, E = field_pair(field)
    mmcs = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    ext_mmcs = ExtensionMmcs(inner=mmcs, D=E.D)
    log_wp = max((width - 1).bit_length(), 0)
    n_vars = log_trace_length + log_wp
    wcfg = WhirConfig.from_security(
        security_level, "johnson", n_vars, field_bits=E.D * F.P.bit_length(),
        log_blowup=log_blowup, folding_factor=2, max_pow_bits=max_pow_bits)
    pcs = {
        "fri": TwoAdicFriPcs(F=F, E=E, fri=fri_params(fri), mmcs=mmcs,
                             fri_mmcs=ext_mmcs),
        "stir": TwoAdicStirPcs(
            F=F, E=E,
            params=StirParameters(log_blowup=log_blowup,
                                  log_folding_factor=log_folding_factor,
                                  security_level=security_level,
                                  max_pow_bits=max_pow_bits),
            mmcs=mmcs, stir_mmcs=ext_mmcs),
        "whir": WhirPcs(F=F, E=E, config=wcfg, mmcs=mmcs, fri_mmcs=ext_mmcs),
    }
    rng = np.random.default_rng(3)
    evals = torch.from_numpy(F.rand_np(
        rng, (1 << log_trace_length, width)).astype(np.int64)).to(dev)
    z = E.rand_h(rng)
    point = [E.rand_h(rng) for _ in range(n_vars)]
    # WHIR's input: the columns one after another, zero-padded to 2^log_wp
    # (built before the timed commit, as the reference builds it)
    stacked = evals.new_zeros((1 << log_wp, 1 << log_trace_length))
    stacked[:width] = F.from_monty_tensor(evals).T

    def challenger():
        return DuplexChallenger(default_poseidon2(F, 24), device=dev,
                                rate=16)

    return PcsJob(F, E, log_trace_length, width, evals, z, n_vars,
                  stacked.reshape(-1), point, pcs, challenger)


def prove_pcs(job: PcsJob, name: str, spans=None) -> dict:
    """Commit and open `job`'s matrix with the PCS `name`; the
    verifier's inputs and the proof, as a dict. spans: a dict of stage
    seconds (STIR's and WHIR's opens fill it)."""
    ch = job.challenger()
    pcs = job.pcs[name]
    if name == "whir":
        commit, data = pcs.commit(job.stacked)
        ch.observe_digest(commit)
        value, proof = pcs.open(data, job.point, ch, spans=spans)
        return dict(commit=commit, value=value, proof=proof)
    domain = pcs.natural_domain_for_degree(1 << job.log_n)
    data = pcs.commit([(domain, job.evals)])
    ch.observe_many(data.root_std)
    opened, proof = pcs.open([(data, [[job.z]])], ch, spans=spans)
    return dict(commit=data.root_std, domain=domain,
                value=opened[0][0][0], proof=proof)


def verify_pcs(job: PcsJob, name: str, run: dict):
    """Verify a `prove_pcs` result (its `value` and `proof`, which a
    probe may have changed); raises the PCS's error."""
    ch = job.challenger()
    pcs = job.pcs[name]
    if name == "whir":
        ch.observe_digest(run["commit"])
        pcs.verify(run["commit"], job.n_vars, job.point, run["value"],
                   run["proof"], ch)
        return
    ch.observe_many(run["commit"])
    pcs.verify([(run["commit"], [(run["domain"], [(job.z, run["value"])])])],
               run["proof"], ch)


def pcs_comparison(field="koala-bear", log_trace_length=10, width=8,
                   fri="testing", log_blowup=2, log_folding_factor=2,
                   security_level=60, max_pow_bits=12, device=None):
    """FRI against STIR and WHIR on one matrix and one opening point (the
    `examples/examples/pcs_comparison.rs` analog), on `device` (default
    cuda). Prints the reference's lines and returns {scheme: (prove
    seconds, verify seconds, proof bytes)}."""
    import torch

    job = pcs_job(field, log_trace_length, width, fri, log_blowup,
                  log_folding_factor, security_level, max_pow_bits, device)
    print(f"pcs comparison: 2^{log_trace_length} x {width} {field} matrix, "
          f"1 opening point")
    results = {}
    for name in ("fri", "stir", "whir"):
        if job.evals.device.type == "cuda":
            torch.cuda.synchronize(job.evals.device)
        t0 = time.perf_counter()
        run = prove_pcs(job, name)
        if job.evals.device.type == "cuda":
            torch.cuda.synchronize(job.evals.device)
        t_prove = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify_pcs(job, name, run)
        t_verify = time.perf_counter() - t0
        size = proof_bytes(run["proof"])
        results[name] = (t_prove, t_verify, size)
        print(f"  {name:<6s} commit+open {t_prove*1e3:9.1f} ms   "
              f"verify {t_verify*1e3:8.1f} ms   proof {size} bytes")
    wcfg = job.pcs["whir"].config
    rep = wcfg.soundness_report(job.n_vars, job.E.D * job.F.P.bit_length())
    print(f"         whir soundness (johnson, target {security_level}b): "
          f"{rep.get('conjectured_bits')} bits  schedule "
          f"queries={list(wcfg.round_queries)} "
          f"pow={list(wcfg.round_pow_bits)}")
    return results


def cmd_pcs_comparison(args):
    dev = _device_or_exit(args.device)
    return pcs_comparison(args.field, args.log_trace_length, args.width,
                          args.fri, args.log_blowup, args.log_folding_factor,
                          args.security_level, args.max_pow_bits, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky3_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prove")
    p.add_argument("--field", default="koala-bear", choices=FIELDS)
    p.add_argument("--objective", default="poseidon-2-permutations",
                   choices=OBJECTIVES)
    p.add_argument("--log-trace-length", type=int, default=10)
    p.add_argument("--log-vector-len", type=int, default=3)
    p.add_argument("--fri", default="benchmark-high-arity", choices=FRIS)
    p.add_argument("--merkle-hash", default="poseidon2",
                   choices=MERKLE_HASHES)
    p.add_argument("--prover", default="host", choices=PROVERS,
                   help="host = the host-transcript prover; fast = the "
                        "device-transcript prover")
    p.add_argument("--repeat", type=int, default=1,
                   help="prove N times; report each (steady-state timing)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (the kernels' plain "
                        "versions)")
    pc = sub.add_parser("pcs-comparison",
                        help="FRI against STIR and WHIR on one matrix")
    pc.add_argument("--field", default="koala-bear",
                    choices=["koala-bear", "baby-bear"])
    pc.add_argument("--log-trace-length", type=int, default=10)
    pc.add_argument("--width", type=int, default=8)
    pc.add_argument("--fri", default="testing", choices=FRIS)
    pc.add_argument("--log-blowup", type=int, default=2)
    pc.add_argument("--log-folding-factor", type=int, default=2)
    pc.add_argument("--security-level", type=int, default=60)
    pc.add_argument("--max-pow-bits", type=int, default=12)
    pc.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.cmd == "prove":
        return cmd_prove(args)
    return cmd_pcs_comparison(args)


if __name__ == "__main__":
    main()
