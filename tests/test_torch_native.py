"""The port's host hashes in C (plonky3_tpu_torch/native/, csrc/host/)
against the port's numpy and torch versions and against the reference's
C library (plonky3_tpu/native/), at random inputs from seeds: the same
words and bytes (tolerance zero).

- keccak-f[1600] batches (u64 states and u32 lane halves), Keccak-256 at
  the padding's edge lengths, Keccak-256 of rows;
- the keccak transcript's proof-of-work grind: the C search, the numpy
  search and the reference's challenger find the same witness;
- the Poseidon2 permutation <16, 3>, <24, 3> (KoalaBear) and <16, 7>,
  <24, 7> (BabyBear), and the duplex transcript, whose full rate blocks
  absorb in one C call: its samples are those of the one-by-one absorb
  and of the reference's host transcript;
- two processes that build the library into a fresh directory at once
  both load it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from plonky3_tpu import native as jnative
from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.challenger.serializing import (
    SerializingChallenger32 as JSerializing,
)
from plonky3_tpu.fields import BabyBear as JBB
from plonky3_tpu.fields import KoalaBear as JKB
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu_torch import native
from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
from plonky3_tpu_torch.challenger.serializing import SerializingChallenger32
from plonky3_tpu_torch.fields import BabyBear, KoalaBear
from plonky3_tpu_torch.hashes import keccak
from plonky3_tpu_torch.hashes.keccak256_mmcs import keccak256_rows_np
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

REPO = Path(__file__).resolve().parent.parent
FIELDS = {"koala-bear": (KoalaBear, JKB), "baby-bear": (BabyBear, JBB)}


@pytest.mark.parametrize("n", [1, 3, 64])
def test_keccakf_batch(n):
    rng = np.random.default_rng(n)
    st = rng.integers(0, 1 << 63, size=(n, 25), dtype=np.uint64)
    got = native.keccakf_batch_u64(st)
    np.testing.assert_array_equal(got, keccak.keccak_f1600_plain(st))
    lo = (st & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (st >> np.uint64(32)).astype(np.uint32)
    for mine, ref in zip(native.keccakf_batch_u32(lo, hi),
                         jnative.keccakf_batch_u32(lo, hi)):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(
        keccak.keccak_f1600_host(st[0].tolist()), got[0])


@pytest.mark.parametrize("length", [0, 1, 31, 135, 136, 137, 271, 272, 1000])
def test_keccak256(length):
    data = np.random.default_rng(length).integers(
        0, 256, size=length, dtype=np.uint8).tobytes()
    got = native.keccak256(data)
    assert got == keccak.keccak256_plain(data) == jnative.keccak256(data)
    assert keccak.keccak256(data) == got


@pytest.mark.parametrize("shape", [(1, 0), (5, 64), (17, 136), (9, 300)])
def test_keccak256_rows(shape):
    rows = np.random.default_rng(shape[1]).integers(
        0, 256, size=shape, dtype=np.uint8)
    got = native.keccak256_rows(rows)
    np.testing.assert_array_equal(got, keccak256_rows_np(rows))
    np.testing.assert_array_equal(got, jnative.keccak256_rows(rows))


@pytest.mark.parametrize("prefix_len", [0, 4, 100, 131, 132, 140, 300])
@pytest.mark.parametrize("bits", [1, 8])
def test_grind_witness(prefix_len, bits):
    """The C search, the numpy search and the reference find the same
    smallest witness after the same observations."""
    words = np.random.default_rng(prefix_len).integers(
        0, KoalaBear.P, size=prefix_len // 4)
    chs = [SerializingChallenger32(KoalaBear) for _ in range(2)]
    jch = JSerializing(JKB)
    for c in chs + [jch]:
        for w in words:
            c.observe(int(w))
    got = chs[0].grind(bits)
    assert got == chs[1].grind_plain(bits) == jch.grind(bits)
    assert chs[0].sample() == chs[1].sample() == jch.sample()


def test_grind_search_matches_numpy():
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, size=40, dtype=np.uint8).tobytes()
    wire = rng.integers(0, 1 << 31, size=5000, dtype=np.uint32)
    digests = keccak.keccak256_np_batch(prefix, wire)
    v = ((digests[:, 31].astype(np.uint32))
         | (digests[:, 30].astype(np.uint32) << 8)
         | (digests[:, 29].astype(np.uint32) << 16)
         | (digests[:, 28].astype(np.uint32) << 24))
    for mask in (0x7, 0xFF, 0xFFF):
        hits = np.nonzero((v & mask) == 0)[0]
        want = int(hits[0]) if hits.size else -1
        assert native.keccak256_grind(prefix, wire, mask) == want
        assert jnative.keccak256_grind(prefix, wire, mask) == want


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("width", [16, 24])
def test_poseidon2_permutation(field, width):
    F, JF = FIELDS[field]
    perm, jperm = default_poseidon2(F, width), j_poseidon2(JF, width)
    states = F.rand_np(np.random.default_rng(width), (6, width), monty=False)
    want = perm.permute_np(states)
    for s, w in zip(states, want):
        got = perm.permute_host(s)
        assert got == w.tolist()
        assert got == jperm.permute_host(s.tolist())
        assert got == [int(x) for x in jperm.permute_host_py(s.tolist())]


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("size", [0, 5, 16, 37, 16 * 40 + 3])
def test_duplex_chain_absorb(field, size):
    """A host duplex transcript absorbing an array (full blocks in one C
    call) samples what the one-by-one absorb and the reference's
    transcript sample."""
    F, JF = FIELDS[field]
    vals = F.rand_np(np.random.default_rng(size), (size,), monty=False)
    fast = DuplexChallenger(default_poseidon2(F, 24))
    slow = DuplexChallenger(default_poseidon2(F, 24))
    ref = JDuplex(j_poseidon2(JF, 24))
    for c in (fast, slow, ref):
        c.observe(7)  # a queued input first: the head goes one by one
    fast.observe_base_array(vals)
    slow.observe_many(vals.tolist())
    ref.observe_base_array(vals)
    assert fast.state == slow.state == [int(x) for x in ref.state]
    for _ in range(20):
        assert fast.sample() == slow.sample() == ref.sample()


def test_duplex_chain_direct():
    perm = default_poseidon2(KoalaBear, 24)
    P, width, d, *tables = perm.native_args
    rng = np.random.default_rng(4)
    state = KoalaBear.rand_np(rng, (24,), monty=False)
    blocks = KoalaBear.rand_np(rng, (9, 16), monty=False)
    got = native.poseidon2_duplex_chain(state, blocks, P, width, 16, d,
                                        *tables)
    want = state.astype(np.int64)
    for b in blocks:
        want[:16] = b
        want[16] = (want[16] + 16) % P
        want = perm.permute_np(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.poseidon2_duplex_chain(
        state, blocks, P, width, 16, d, *tables))


def test_goldilocks_duplex_observes_wide_values_whole():
    """The Goldilocks transcript has no C chain: an array with values of
    2^32 and more is observed whole, as the reference's transcript
    observes them one by one."""
    from plonky3_tpu.gl.stark import GLDuplexChallenger as JGLDuplex
    from plonky3_tpu_torch.gl.stark import GLDuplexChallenger

    P = JGLDuplex().perm.F.P
    rng = np.random.default_rng(9)
    vals = rng.integers(1 << 32, P, (11,), dtype=np.uint64)
    vals[3] = P - 1
    ours, ref = GLDuplexChallenger(), JGLDuplex()
    ours.observe_base_array(vals)
    ref.observe_many([int(x) for x in vals])
    assert ours.state == [int(x) for x in ref.state]
    assert [ours.sample() for _ in range(6)] == [ref.sample()
                                                 for _ in range(6)]


def test_two_processes_build_a_fresh_directory_at_once(tmp_path):
    code = ("import sys; from plonky3_tpu_torch import native as n; "
            "lib = n.lib(sys.argv[1]); "
            "print(n.so_path(sys.argv[1]).exists(), "
            "n.keccak256(b'abc').hex())")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = keccak.keccak256_plain(b"abc").hex()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", want]
    # one library, no temporary left behind
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler failure raises with its output (there is no fallback)."""
    bad = tmp_path / "src"
    bad.mkdir()
    for name in native.SOURCES:
        (bad / name).write_text("this is not C\n")
    monkeypatch.setattr(native, "_SRC_DIR", bad)
    with pytest.raises(RuntimeError, match="building csrc/host failed"):
        native.build(tmp_path / "build")
