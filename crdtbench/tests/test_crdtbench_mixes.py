"""The benchmark's frozen traffic generators equal the repository's own at
seed 0 with no rotation, and draw from the seed otherwise."""

import numpy as np
import pytest

from crdtbench import traffic

import chip_smoke
from repro_torch.sync import workloads as W


@pytest.mark.parametrize("objects,nodes,rounds,ops,zipf", [
    (96, 16, 40, 6, 1.0), (300, 50, 7, 10, 1.0), (97, 8, 5, 3, 0.5)])
def test_retwis_schedule_equals_the_port(objects, nodes, rounds, ops, zipf):
    spec = W.retwis(objects, nodes, rounds, ops, zipf, seed=0)
    for got, want in zip(traffic.retwis_streams(objects, nodes, rounds, ops,
                                                zipf, 0), spec.streams()):
        np.testing.assert_array_equal(got, want)
    got = traffic.retwis_counts(objects, nodes, rounds, ops, zipf, 0)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, spec.update_counts())


def test_retwis_weights_equal_the_port():
    np.testing.assert_array_equal(traffic.retwis_weights(301),
                                  W.retwis_weights(301))


@pytest.mark.parametrize("nodes,keys,k", [(15, 4096, 10), (15, 1000, 100),
                                          (7, 999, 10)])
def test_key_blocks_equal_the_port(nodes, keys, k):
    got = traffic.key_blocks(nodes, keys, k)
    np.testing.assert_array_equal(got, W.gmap_key_blocks(nodes, keys, k))
    np.testing.assert_array_equal(traffic.key_blocks(nodes, keys, k, 123),
                                  np.roll(got, 123, axis=1))


def test_join_start_equals_the_smoke():
    import torch

    got = traffic.join_start(15, 4096, 1024, 0.25, 64, 1)
    want = chip_smoke.join_x0(15, 4096, 0.25, tile=1024, value=1,
                              dtype=torch.int32)
    np.testing.assert_array_equal(got, want.numpy())


def test_join_tiles_hold_the_same_share_on_every_seed():
    mix = {"kind": "join", "tile": 1024, "block": 64, "held": 0.25,
           "value": 1}
    cfg = {"keys": 8192, "topology": {"nodes": 15}}
    a = traffic.generate(mix, cfg, 1)[0]["x0"]
    b = traffic.generate(mix, cfg, 2)[0]["x0"]
    assert not np.array_equal(a, b)
    for x in (a, b):
        assert (x[0] == 0).all() and (x[1:] == x[1]).all()
        held = (x[1].reshape(8, 16, 64) != 0)
        assert (held.all(-1) | ~held.any(-1)).all()      # whole blocks
        assert (held.all(-1).sum(-1) == 4).all()         # 4 of 16 a tile


def test_generate_is_a_function_of_the_seed():
    mix = {"kind": "store", "zipf": 1.0, "ops_per_node": 4, "pool": 2}
    cfg = {"objects": 50, "topology": {"nodes": 8},
           "rounds": {"active": 5, "quiet": 1}}
    big = 2 ** 33 + 7
    one, two = traffic.generate(mix, cfg, big), traffic.generate(mix, cfg, big)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a["counts"], b["counts"])
    assert not np.array_equal(one[0]["counts"], one[1]["counts"])
    other = traffic.generate(mix, cfg, big + 1)
    assert not np.array_equal(one[0]["counts"], other[0]["counts"])


def test_gmap_rotation_keeps_the_work():
    mix = {"kind": "map_blocks", "k_pct": 10}
    cfg = {"keys": 4096, "topology": {"nodes": 15}}
    sizes = {int(traffic.generate(mix, cfg, s)[0]["blocks"].sum())
             for s in range(5)}
    assert sizes == {int(W.gmap_key_blocks(15, 4096, 10).sum())}
