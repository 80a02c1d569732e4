"""Rescue and RPO of plonky3_tpu_torch against plonky3_tpu's: the three
RPO known-answer vectors of the reference's tests (BabyBear, Mersenne31,
Goldilocks; rpo/{baby_bear,mersenne_31,goldilocks}.rs), the SHAKE-256
round constants, `RpoKoalaBear` (host and numpy) and a Rescue-XLIX
instance against the reference's. Every comparison is exact."""

import numpy as np
import pytest

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.hashes import rescue as j_rescue
from plonky3_tpu_torch.fields import BabyBear as BB
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import rescue

KATS = {
    "rpo_baby_bear": [
        580889464, 812545993, 1435256485, 1944190928, 468280959,
        1574957037, 614259202, 1971827593, 1157818138, 41725352,
        1454051006, 1975269624, 1052998898, 1151877439, 1238988248,
        973164623, 1378588581, 1290093470, 599149080, 819216820,
        1015689941, 1980884825, 607611746, 918354105,
    ],
    "rpo_mersenne31": [
        1990425063, 95513650, 1492148912, 1455268556, 347571427,
        1892690094, 34080484, 1175631837, 1348619901, 1096114017,
        310913313, 1912324205, 609442899, 2112777835, 1331189849,
        507241525, 1800223977, 568712449, 2123164950, 86025361,
        1585828474, 1334334486, 188486534, 1147991035,
    ],
    "rpo_goldilocks": [
        15056646954853821376, 594518210294093573, 10395398226526937664,
        3903707756219396109, 7670128982698747483, 4249514323476682720,
        16506822133651532340, 10593868791806571942, 9413309068803954142,
        15946782832277734471, 7904287043744270535, 16548919317472389167,
    ],
}


@pytest.mark.parametrize("name", sorted(KATS))
def test_rpo_kat(name):
    perm = getattr(rescue, name)()
    out = perm.permute_host(list(range(perm.width)))
    assert out == KATS[name]
    assert out == getattr(j_rescue, name)().permute_host(
        list(range(perm.width)))


@pytest.mark.parametrize("name", sorted(KATS))
def test_rpo_round_constants_equal_reference(name):
    ours, ref = getattr(rescue, name)(), getattr(j_rescue, name)()
    assert ours.rcs == ref.rcs and ours.alpha_inv == ref.alpha_inv


def test_rpo_koalabear_equals_reference():
    ours, ref = rescue.RpoKoalaBear(F), j_rescue.RpoKoalaBear(JF)
    assert ours.rcs == ref.rcs and len(ours.rcs) == 15 * 24
    rng = np.random.default_rng(4)
    for _ in range(3):
        st = [int(x) for x in rng.integers(0, F.P, 24)]
        assert ours.permute_host(st) == ref.permute_host(st)
    states = rng.integers(0, F.P, (7, 24), dtype=np.uint64).astype(np.uint32)
    got = ours.permute_np(states)
    assert got.dtype == np.uint32
    assert np.array_equal(got, ref.permute_np(states))
    assert got[2].tolist() == ours.permute_host(states[2].tolist())


def test_rescue_equals_reference():
    """A Rescue-XLIX instance over BabyBear (width 12, alpha 7, 8 rounds,
    SHAKE-256 constants, the Poseidon1 width-24 row cut to 12)."""
    from plonky3_tpu_torch.hashes.constants.poseidon1_constants import (
        BABYBEAR_MDS_FIRST_ROW_24)

    rcs = rescue.shake_round_constants(BB, b"Rescue-XLIX test", 12, 8, 5,
                                       False)
    assert rcs == j_rescue.shake_round_constants(BB, b"Rescue-XLIX test",
                                                 12, 8, 5, False)
    kw = dict(width=12, alpha=7, num_rounds=8, round_constants=tuple(rcs),
              mds_first_row=BABYBEAR_MDS_FIRST_ROW_24[:12])
    ours = rescue.Rescue(F=BB, **kw)
    ref = j_rescue.Rescue(F=BB, **kw)
    st = [int(x) for x in np.random.default_rng(6).integers(0, BB.P, 12)]
    assert ours.alpha_inv == ref.alpha_inv
    assert ours.permute_host(st) == ref.permute_host(st)
