"""The port's Goldilocks field, Poseidon2-GL, sponge, compression, Merkle
tree and NTT against the JAX package's (plonky3_tpu/fields/goldilocks*.py,
hashes/poseidon2_goldilocks.py, gl/), word for word.

Inputs come from seeded numpy and go to both packages; the JAX side runs
on the CPU (its small pair kernels jitted, its permutation op by op, its
host sponge and compressor in Python ints). Every comparison is exact."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.fields import goldilocks_device as jgd
from plonky3_tpu.fields.goldilocks import Goldilocks as JG
from plonky3_tpu.fields.goldilocks import GoldilocksExt2Field as JE
from plonky3_tpu.gl import field as jfield
from plonky3_tpu.gl import merkle as jmerkle
from plonky3_tpu.gl import ntt as jntt
from plonky3_tpu.hashes.poseidon2_goldilocks import (
    poseidon2_goldilocks_permute as j_permute,
)
from plonky3_tpu_torch.fields import goldilocks_device as gd
from plonky3_tpu_torch.fields.goldilocks import Goldilocks as G
from plonky3_tpu_torch.gl import field as gf
from plonky3_tpu_torch.gl.merkle import gl_merkle_mmcs
from plonky3_tpu_torch.gl.ntt import gl_coset_lde_batch, gl_dft, gl_idft
from plonky3_tpu_torch.hashes import poseidon2_goldilocks_cuda as pgc
from plonky3_tpu_torch.hashes.poseidon2_goldilocks import (
    poseidon2_goldilocks_permute,
    poseidon2_goldilocks_permute_np,
)
from torch_gl_reference import HostSponge

P = G.P

# tests/test_goldilocks_device.py:61, the carry and borrow edges
EDGE = np.array(
    [0, 1, 2, 0xFFFFFFFF, 0x100000000, P - 1, P - 2,
     0xFFFFFFFF00000000, 0x7FFFFFFFFFFFFFFF, 0x123456789ABCDEF],
    np.uint64,
)
# goldilocks/src/poseidon2.rs:1236-1253, the permutation of [0, 1, ..., 7]
KAT = [0x020CF04A1B214D14, 0x84E14AAAEACAED25, 0x1AE0F640E81C7457,
       0xA4D204CBAEB0D8A5, 0x0CF637B627B3A7FF, 0x788D304D948B486B,
       0x7327133EA1949AF4, 0xF415ABB924DA395B]


def _t(x64):
    return gf.to_tensor(x64)


def _n(t):
    return gf.to_numpy(t)


def _jax_pairs(x64):
    lo, hi = jgd.split_np(x64)
    return jnp.asarray(lo), jnp.asarray(hi)


def _jax_back(pair):
    return jgd.join_np(np.asarray(pair[0]), np.asarray(pair[1]))


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.repeat(EDGE, len(EDGE)),
                        rng.integers(0, P, 2048, dtype=np.uint64)])
    b = np.concatenate([np.tile(EDGE, len(EDGE)),
                        rng.integers(0, P, 2048, dtype=np.uint64)])
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "square"])
def test_base_ops_match_jax_and_host(op):
    """Random pairs and every edge x edge pair against the JAX pair
    kernels and exact ints."""
    a, b = _operands(0)
    ta, tb = _t(a), _t(b)
    got = {"add": lambda: gd.add(ta, tb), "sub": lambda: gd.sub(ta, tb),
           "mul": lambda: gd.mul(ta, tb), "neg": lambda: gd.neg(ta),
           "square": lambda: gd.square(ta)}[op]()
    jf = {"add": jgd.add, "sub": jgd.sub, "mul": jgd.mul,
          "neg": lambda x, _: jgd.neg(x), "square": lambda x, _: jgd.mul(x, x)}
    want = _jax_back(jax.jit(jf[op])(_jax_pairs(a), _jax_pairs(b)))
    assert (_n(got) == want).all()
    host = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
            "mul": lambda x, y: x * y % P, "neg": lambda x, y: -x % P,
            "square": lambda x, y: x * x % P}[op]
    assert [int(v) for v in _n(got)] == [
        host(int(x), int(y)) for x, y in zip(a, b)]


def test_inverse_halve_and_sums():
    rng = np.random.default_rng(1)
    x = np.concatenate([EDGE[1:], rng.integers(1, P, 200, dtype=np.uint64)])
    inv = _n(gd.inv(_t(x)))
    assert all(int(i) == pow(int(v), P - 2, P) for i, v in zip(inv, x))
    half = _n(gf.halve(_t(x)))
    want = _jax_back(jax.jit(jfield.halve)(_jax_pairs(x)))
    assert (half == want).all()
    m = rng.integers(0, P, (37, 5), dtype=np.uint64)
    m[0] = P - 1
    for dim in (0, 1):
        got = _n(gd.sum_mod(_t(m), dim))
        want = [sum(int(v) for v in row) % P
                for row in (m.T if dim == 0 else m)]
        assert [int(v) for v in got] == want


def test_ext2_ops_match_jax_and_host():
    rng = np.random.default_rng(11)
    a = rng.integers(0, P, (64, 2), dtype=np.uint64)
    b = rng.integers(0, P, (64, 2), dtype=np.uint64)
    a[0], b[0] = (P - 1, P - 1), (P - 1, 1)
    got = _n(gf.ext_mul(_t(a), _t(b)))
    want = jfield.join_host(np.asarray(jax.jit(jfield.GLE.mul)(
        jnp.asarray(jfield.split_host(a)), jnp.asarray(jfield.split_host(b)))))
    assert (got == want).all()
    for i in range(64):
        ai, bi = tuple(map(int, a[i])), tuple(map(int, b[i]))
        assert tuple(int(v) for v in got[i]) == JE.mul_h(ai, bi)
    inv = _n(gf.ext_inv(_t(a)))
    for i in range(64):
        assert tuple(int(v) for v in inv[i]) == JE.inv_h(
            tuple(map(int, a[i])))
    alpha = (int(a[3, 0]), int(a[3, 1]))
    jp = jfield.join_host(jfield.GLE.powers_np(alpha, 9))
    assert (gf.GLE.powers_np(alpha, 9) == jp).all()


def test_wire_form_is_the_references_interleaved_u32():
    rng = np.random.default_rng(2)
    x = rng.integers(0, P, (5, 7), dtype=np.uint64)
    words = gf.wire32(_t(x)).numpy().view(np.uint32)
    assert (words == jfield.split_host(x)).all()
    assert (gf.join_host(words) == x).all()
    assert (gf.split_host(x) == jfield.split_host(x)).all()


def test_poseidon2_kat_and_permutations():
    """The KAT, then random states: the plain tensor permutation, the
    numpy batch and the host permutation against the JAX package's pair
    permutation (op by op: its XLA compile takes minutes on the CPU) and
    its host permutation."""
    assert poseidon2_goldilocks_permute(list(range(8))) == KAT
    rng = np.random.default_rng(3)
    states = rng.integers(0, P, (24, 8), dtype=np.uint64)
    states[0] = np.arange(8)
    states[1] = P - 1
    states[2] = 0
    plain = _n(gd.poseidon2_goldilocks_plain(_t(states)))
    with jax.disable_jit():
        want = _jax_back(jgd.poseidon2_goldilocks_device(
            _jax_pairs(states)))
    assert (plain == want).all()
    assert [int(v) for v in plain[0]] == KAT
    assert (poseidon2_goldilocks_permute_np(states) == want).all()
    assert (_n(pgc.gl_permute(_t(states))) == want).all()
    for i in range(len(states)):
        row = [int(v) for v in states[i]]
        assert poseidon2_goldilocks_permute(row) == j_permute(row)
        assert [int(v) for v in want[i]] == j_permute(row)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 7, 8, 13, 64])
def test_sponge_matches_jax_hash_rows_np(width):
    """The plain sponge (the CPU wrapper) and the host numpy batch
    against GLPoseidonSponge.hash_rows_np, widths 1 to 64 (tails of 1 to 3
    elements included)."""
    rng = np.random.default_rng(100 + width)
    mat = rng.integers(0, P, (6, width), dtype=np.uint64)
    mat[0] = P - 1
    want = jfield.join_host(jmerkle.GLPoseidonSponge().hash_rows_np(
        [jfield.split_host(mat)]))
    got = _n(pgc.gl_sponge_rows(_t(mat)))
    assert (got == want).all()
    sponge = gl_merkle_mmcs().sponge
    assert (sponge.hash_rows_np([mat]) == want).all()
    assert sponge.hash_iter_host(int(v) for v in mat[1]) == tuple(
        int(v) for v in want[1])


def test_compressor_matches_jax():
    rng = np.random.default_rng(7)
    left = rng.integers(0, P, (9, 4), dtype=np.uint64)
    right = rng.integers(0, P, (9, 4), dtype=np.uint64)
    want = jfield.join_host(jmerkle.GLCompressor().compress_np(
        jfield.split_host(left), jfield.split_host(right)))
    assert (_n(pgc.gl_compress(_t(left), _t(right))) == want).all()
    comp = gl_merkle_mmcs().compressor
    assert (comp.compress_np(left, right) == want).all()
    pairs = _t(np.concatenate([left, right], axis=1)).reshape(9, 2, 4)
    assert (_n(pgc.gl_compress(pairs[:, 0], pairs[:, 1])) == want).all()


@pytest.mark.parametrize("cap", [0, 2])
def test_merkle_root_matches_jax(cap):
    """A mixed-height commit (16 x 3 beside 4 x 2, injected): the port's
    root or cap equals the JAX MMCS's (hashing on the host, as
    `tests/torch_gl_reference.py` says); a pruned opening verifies and a
    changed value fails."""
    rng = np.random.default_rng(5 + cap)
    tall = rng.integers(0, P, (16, 3), dtype=np.uint64)
    short = rng.integers(0, P, (4, 2), dtype=np.uint64)
    mmcs = gl_merkle_mmcs(cap_height=cap)
    data = mmcs.commit([_t(tall), _t(short)])
    jmmcs = jmerkle.GLMerkleTreeMmcs(sponge=HostSponge(),
                                     compressor=jmerkle.GLCompressor(),
                                     cap_height=cap)
    jdata = jmmcs.commit(
        [jnp.asarray(jfield.split_host(tall)),
         jnp.asarray(jfield.split_host(short))])
    assert data.commitment == jdata.commitment
    idx = [3, 12, 3]
    rows, proof = mmcs.open_multi_batch(data, idx)
    dims = [(16, 3), (4, 2)]
    assert mmcs.verify_multi_batch(data.commitment, dims, idx, rows, proof)
    bad = [[list(m) for m in r] for r in rows]
    bad[1][0][2] = (bad[1][0][2] + 1) % P
    assert not mmcs.verify_multi_batch(data.commitment, dims, idx, bad,
                                       proof)


@pytest.mark.parametrize("log_n,width", [(0, 3), (1, 2), (4, 5), (6, 3)])
def test_dft_idft_match_jax(log_n, width):
    rng = np.random.default_rng(log_n + 10 * width)
    n = 1 << log_n
    vals = rng.integers(0, P, (n, width), dtype=np.uint64)
    got = _n(gl_dft(_t(vals)))
    pairs = _jax_pairs(vals)
    want = _jax_back(jntt.gl_dft(pairs))
    assert (got == want).all()
    back = _n(gl_idft(_t(got)))
    assert (back == vals).all()
    assert (back == _jax_back(jntt.gl_idft(_jax_pairs(got)))).all()


@pytest.mark.parametrize("log_n,width,added", [(3, 2, 1), (5, 4, 2),
                                               (6, 3, 1)])
def test_coset_lde_matches_jax(log_n, width, added):
    rng = np.random.default_rng(log_n * 7 + width)
    vals = rng.integers(0, P, (1 << log_n, width), dtype=np.uint64)
    shift = G.mul_h(7, G.inv_h(3))
    lde, cf = gl_coset_lde_batch(_t(vals), added, shift, with_coeffs=True)
    jlde, jcf = jntt.gl_coset_lde_batch(_jax_pairs(vals), added, shift,
                                        with_coeffs=True)
    assert (_n(lde) == _jax_back(jlde)).all()
    assert (_n(cf) == _jax_back(jcf)).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pgc.gl_permute(x)
    with pytest.raises(ValueError):
        pgc.gl_compress(torch.zeros((4, 4), dtype=torch.int64),
                        torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        pgc.gl_sponge_rows(torch.zeros(4, dtype=torch.int64))


def test_gl_modules_import_no_jax_triton_or_reference():
    """Importing the Goldilocks prover, MonolithGoldilocksAir, the
    MultiField32 transcript, the STIR PCS, the multilinear STARK and the
    transcript schemas loads neither jax, nor plonky3_tpu, nor triton (a
    fresh interpreter, read from sys.modules)."""
    code = (
        "import sys\n"
        "import plonky3_tpu_torch.gl.stark\n"
        "import plonky3_tpu_torch.models.monolith_gl_air\n"
        "import plonky3_tpu_torch.challenger.multi_field\n"
        "import plonky3_tpu_torch.stir.pcs\n"
        "import plonky3_tpu_torch.multilinear.multi_stark\n"
        "import plonky3_tpu_torch.challenger.schema\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'plonky3_tpu', 'triton'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
