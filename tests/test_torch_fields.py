"""plonky3_tpu_torch fields, bit utilities, constants and package rules,
held against plonky3_tpu with exact equality (every value is an integer
mod P or a u32 word)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.utils import bits as jbits
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
from plonky3_tpu_torch.utils import bits

REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def _pair(seed, shape=(257,)):
    rng = np.random.default_rng(seed)
    a, b = JF.rand_np(rng, shape), JF.rand_np(rng, shape)
    a[:3], b[:3] = [0, 1, JF.P - 1], [JF.P - 1, 0, 1]
    return a, b


def test_constants_match_reference():
    for k in ("P", "MU", "TWO_ADICITY", "GENERATOR", "TWO_ADIC_GENERATORS"):
        assert getattr(F, k) == getattr(JF, k)
    for k in ("D", "W", "DTH_ROOT", "EXT_GENERATOR", "EXT_TWO_ADICITY"):
        assert getattr(E, k) == getattr(JE, k)


def test_poseidon2_constants_match_reference():
    ours = default_poseidon2(F, 16)._device_consts()
    ref = j_poseidon2(JF, 16)._device_consts()
    assert set(ours) == set(ref)
    for k in ref:
        assert np.array_equal(ours[k], np.asarray(ref[k])), k


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("seed", [0, 1])
def test_monty_binary_ops(op, seed):
    a, b = _pair(seed)
    want = getattr(JF, f"{op}_np")(a, b)
    assert np.array_equal(_u32(getattr(F, op)(_t(a), _t(b))), want)


@pytest.mark.parametrize("seed", [2, 3])
def test_monty_inv_halve_exp(seed):
    a, _ = _pair(seed)
    a = a[a != 0]
    assert np.array_equal(_u32(F.inv(_t(a))), JF.batch_inv_np(a))
    assert np.array_equal(_u32(F.halve(_t(a))), JF.halve_np(a))
    want = JF.mul_np(JF.mul_np(a, a), a)
    assert np.array_equal(_u32(F.exp(_t(a), 3)), want)


def test_monty_host_conversions():
    rng = np.random.default_rng(4)
    x = JF.rand_np(rng, (64,), monty=False)
    assert np.array_equal(F.to_monty_np(x), JF.to_monty_np(x))
    assert np.array_equal(F.from_monty_np(x), JF.from_monty_np(x))
    assert np.array_equal(F.shoup_np(x), JF.shoup_np(x))
    assert np.array_equal(F.rand_np(np.random.default_rng(9), (5, 3)),
                          JF.rand_np(np.random.default_rng(9), (5, 3)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ext_mul_and_inv(seed):
    rng = np.random.default_rng(seed)
    a = JF.rand_np(rng, (33, 4))
    b = JF.rand_np(rng, (33, 4))
    want = JE.mul_np(a, b)
    assert np.array_equal(_u32(E.mul(_t(a), _t(b))), want)
    assert np.array_equal(E.mul_np(a, b), want)
    inv = _u32(E.inv(_t(a)))
    for i in range(4):
        h = JE.from_monty_np(a[i])
        assert JE.from_monty_np(inv[i]) == JE.inv_h(h)
        assert E.inv_h(h) == JE.inv_h(h)
    z = JE.rand_h(rng)
    assert np.array_equal(E.powers_np(z, 37), JE.powers_np(z, 37))


@pytest.mark.parametrize("log_n", [0, 1, 5, 9])
def test_bits(log_n):
    assert np.array_equal(bits.bitrev_indices(log_n),
                          jbits.bitrev_indices(log_n))
    x = torch.arange(3 << log_n).reshape(1 << log_n, 3)
    want = jbits.bitrev_permute_axis0(x.numpy(), log_n)
    assert np.array_equal(bits.bitrev_permute_axis0(x, log_n).numpy(), want)
    assert bits.log2_strict(1 << log_n) == log_n
    assert bits.reverse_bits_len(5, 7) == jbits.reverse_bits_len(5, 7)


def test_import_pulls_in_no_jax_or_reference():
    """Importing every module of the port (and chip_smoke.py) loads
    neither jax nor plonky3_tpu nor triton."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import plonky3_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import plonky3_tpu_torch.stir.pcs\n"
        "import plonky3_tpu_torch.multilinear.multi_stark\n"
        "import plonky3_tpu_torch.challenger.schema\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'plonky3_tpu', 'triton')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
