"""The control (the reference with one receive slot's messages lost every
round and the sender's buffer cleared all the same) comes out not correct
on every cell and seed; the reference itself comes out exact."""

import pytest

from crdtbench import check, harness, traffic
from crdtbench.control import DROP

CELLS = ("retwis30k.bprr", "gmap4m.bprr", "gmap4m.join-digest",
         "retwis.sharded")


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 13])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_reference_holds(test_bench, small_root,
                                                   cell, seed):
    entry_cell, config, mix = harness.find_cell(test_bench, cell, small_root)
    devices = ["cpu"] * entry_cell["chips"]
    entry = traffic.generate(dict(mix, pool=1), config, seed)[0]
    ref = check.reference_answer(config, mix, entry, devices)
    assert not any(check.judge(config, mix, entry, ref, devices).values())
    ctl = check.reference_answer(config, mix, entry, devices, drop=DROP)
    got = check.judge(config, mix, entry, ctl, devices)
    assert any(got[k] > check.LIMITS[k] for k in got), got
