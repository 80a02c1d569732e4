"""The port's zk codes (plonky3_tpu_torch/multilinear/zk_codes.py) against
the reference's (plonky3_tpu/multilinear/zk_codes.py).

The same seeded draws go through both packages: the codewords must be the
same u32 words (tolerance zero), at several (t, message, length, shift)
shapes. On the port alone: linearity, message recovery by the inverse
DFT, one position uniform over the randomness, and `simulate`'s budget
(the values are the reference's; past the budget the reference asserts,
the port raises ValueError).
"""

import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.multilinear.zk_codes import (
    ReedSolomonZkEncoding as JEncoding,
)
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.multilinear.zk_codes import ReedSolomonZkEncoding
from plonky3_tpu_torch.ops.ntt import idft

# (t, msg_len, log_m, shift): the reference tests' shapes, a coset and a
# message + randomness that fill the codeword
SHAPES = [(4, 8, 5, 1), (1, 4, 3, 1), (3, 4, 4, 1), (5, 11, 5, 3),
          (8, 8, 4, 1)]


def _pair(t, msg_len, log_m, shift):
    return (ReedSolomonZkEncoding(F=F, t=t, msg_len=msg_len, log_m=log_m,
                                  shift_std=shift, device="cpu"),
            JEncoding(F=JF, t=t, msg_len=msg_len, log_m=log_m,
                      shift_std=shift))


@pytest.mark.parametrize("shape", SHAPES)
def test_codeword_equals_reference(shape):
    ours, ref = _pair(*shape)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    msg = F.rand_np(rng, (ours.msg_len,), monty=False)
    jmsg = JF.rand_np(jrng, (ref.msg_len,), monty=False)
    r, jr = ours.sample_randomness(rng), ref.sample_randomness(jrng)
    assert (r == jr).all() and (msg == jmsg).all()
    cw = ours.encode_with_randomness(msg, r)
    assert cw.dtype == np.uint32 and cw.shape == (1 << ours.log_m,)
    np.testing.assert_array_equal(cw, np.asarray(
        ref.encode_with_randomness(jmsg, jr)))
    # encode draws its randomness as the reference's does
    np.testing.assert_array_equal(
        ours.encode(msg, np.random.default_rng(1)),
        np.asarray(ref.encode(msg, np.random.default_rng(1))))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_linearity_and_message_recovery(shape):
    enc, _ = _pair(*shape)
    rng = np.random.default_rng(0)
    msg = F.rand_np(rng, (enc.msg_len,), monty=False)
    r = enc.sample_randomness(rng)
    cw = enc.encode_with_randomness(msg, r)
    msg2 = F.rand_np(rng, (enc.msg_len,), monty=False)
    r2 = enc.sample_randomness(rng)
    cw2 = enc.encode_with_randomness(msg2, r2)
    s_msg = ((msg.astype(np.uint64) + msg2) % F.P).astype(np.uint32)
    s_r = ((r.astype(np.uint64) + r2) % F.P).astype(np.uint32)
    cw_sum = enc.encode_with_randomness(s_msg, s_r)
    assert (((cw.astype(np.uint64) + cw2) % F.P) == cw_sum).all()
    # over the subgroup the natural-order codeword is the DFT of
    # [msg || r || 0]: the inverse DFT gives them back
    words = torch.from_numpy(F.to_monty_np(cw).astype(np.int64))
    coeffs = F.from_monty_np(idft(F, words.reshape(-1, 1))[:, 0].numpy())
    want = np.zeros(1 << enc.log_m, np.uint32)
    want[:enc.msg_len] = msg
    want[enc.msg_len:enc.msg_len + enc.t] = r
    np.testing.assert_array_equal(coeffs, want)


def test_single_position_uniform():
    """One codeword position of a fixed message is uniform over the
    encoding's randomness (the t-query perfect simulation property)."""
    rng = np.random.default_rng(1)
    enc = ReedSolomonZkEncoding(F=F, t=1, msg_len=4, log_m=3, device="cpu")
    msg = np.zeros(4, np.uint32)  # the worst case: an all-zero message
    vals = {int(enc.encode(msg, rng)[5]) for _ in range(64)}
    # 64 draws of a uniform field element collide with negligible odds
    assert len(vals) >= 60


def test_simulate_budget_matches_reference():
    enc, ref = _pair(3, 4, 4, 1)
    vals = enc.simulate([1, 5, 1, 9], np.random.default_rng(2))
    np.testing.assert_array_equal(
        vals, ref.simulate([1, 5, 1, 9], np.random.default_rng(2)))
    assert vals[0] == vals[2]  # duplicates agree
    with pytest.raises(ValueError):
        enc.simulate([0, 1, 2, 3], np.random.default_rng(2))
    with pytest.raises(AssertionError):
        ref.simulate([0, 1, 2, 3], np.random.default_rng(2))


def test_oversized_encoding_refused():
    with pytest.raises(ValueError):
        ReedSolomonZkEncoding(F=F, t=5, msg_len=4, log_m=3, device="cpu")
