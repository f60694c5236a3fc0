"""The Scuttlebutt baseline, JAX against the port, and the port against the
paper's committed numbers.

* Parity: the port's ``scuttlebutt.simulate`` over the GSet, GCounter and
  GMap codecs (``repro_torch.sync.workloads``) on the paper's tree15 and
  mesh15 equals ``repro.sync.scuttlebutt.simulate`` over the JAX codecs
  (those of ``benchmarks/common.py``, built here): per-round tx, metadata,
  memory, cpu, the worst node, the final version vectors and the final
  states.
* Committed values: fig7's four ``scuttlebutt`` rows, fig10's
  ``scuttlebutt`` column and fig9's measured entries per round, value for
  value.
* The seen-map's direct observation is a scatter-max: on a tree the
  padded neighbour slots repeat node 0's index, and a last-write scatter
  would lose what a real slot wrote there.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sync import scuttlebutt as jsb
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from test_scuttlebutt import gcounter_codec as jax_gcounter_codec
from test_scuttlebutt import gset_codec as jax_gset_codec

from repro_torch.sync import scuttlebutt as sb
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as W

torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
FIELDS = ("tx", "meta_tx", "mem", "cpu", "max_mem_node", "final_kv")
NODES, EVENTS, QUIET, KEYS = 15, 100, 20, 1000   # the paper's (fig7-fig10)


def jax_gmap_codec(k_pct, nodes, keys=KEYS):
    """``benchmarks/common.py``'s ``scuttlebutt_gmap_codec``."""
    blocks_b = jW.gmap_key_blocks(nodes, keys, k_pct)
    per_node = int(blocks_b.sum(axis=1)[0])
    blocks = jnp.asarray(blocks_b.astype(np.int32))

    def range_join(lo, hi):
        ver = jnp.where(hi > lo, hi, 0)
        return jnp.max(blocks[None] * ver[..., :, None], axis=-2)

    return jsb.DeltaCodec(
        range_join=range_join,
        delta_elems=jnp.full((nodes,), per_node, jnp.int32),
        state_size=lambda kv: jnp.sum((kv > 0) * per_node, axis=-1))


def codecs(name, nodes=15, events=20):
    """(JAX codec, port codec) of one benchmark type."""
    if name == "gset":
        return (jax_gset_codec(nodes, events),
                W.scuttlebutt_gset_codec(nodes, events))
    if name == "gcounter":
        return (jax_gcounter_codec(nodes),
                W.scuttlebutt_gcounter_codec(nodes))
    k = int(name[4:])
    return jax_gmap_codec(k, nodes), W.scuttlebutt_gmap_codec(k, nodes, KEYS)


def assert_same(got, want, ctx):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(got.final_x.numpy(),
                                  np.asarray(want.final_x),
                                  err_msg=f"{ctx}: final_x")
    assert got.total_tx == want.total_tx


@pytest.mark.parametrize("topo_name", ["tree", "mesh"])
@pytest.mark.parametrize("codec", ["gset", "gcounter", "gmap10"])
def test_matches_jax(codec, topo_name):
    jc, tc = codecs(codec)
    want = jsb.simulate(jc, jtopo.by_name(topo_name, 15, 4), 20, 10)
    got = sb.simulate(tc, ttopo.by_name(topo_name, 15, 4), 20, 10,
                      device="cpu")
    assert_same(got, want, f"{codec}/{topo_name}")
    assert got.tx.shape == (30,)


@pytest.mark.parametrize("row", ["gset_tree", "gcounter_tree", "gset_mesh",
                                 "gcounter_mesh"])
def test_fig7_rows(row):
    """fig7's ``scuttlebutt`` rows, as ``benchmarks/fig7_transmission.py``
    computes them (100 active + 20 quiet rounds; the summary vectors
    charged for the active rounds)."""
    fig = json.loads((RESULTS / "fig7_transmission.json").read_text())
    bench, topo_name = row.split("_")
    topo = ttopo.by_name(topo_name, NODES, 4)
    _, codec = codecs(bench, NODES, EVENTS)
    r = sb.simulate(codec, topo, EVENTS, QUIET, device="cpu")
    got = {"tx": r.total_tx + sb.summary_vector_elems(topo.num_edges,
                                                      NODES, EVENTS),
           "tx_data_only": r.total_tx, "mem_avg": float(r.mem.mean()),
           "mem_max_node": int(r.max_mem_node.max()),
           "cpu": int(r.cpu.sum())}
    assert got == fig[row]["raw"]["scuttlebutt"]


@pytest.mark.parametrize("bench", ["gcounter", "gset", "gmap10", "gmap100"])
def test_fig10_column(bench):
    """fig10's ``scuttlebutt`` memory column (mesh15, 100 + 20 rounds)."""
    fig = json.loads((RESULTS / "fig10_memory.json").read_text())
    _, codec = codecs(bench, NODES, EVENTS)
    r = sb.simulate(codec, ttopo.partial_mesh(NODES, 4), EVENTS, QUIET,
                    device="cpu")
    assert float(r.mem.mean()) == fig[bench]["raw"]["scuttlebutt"]


def test_fig9_entries_and_curves():
    """fig9's measured metadata entries per round at N = 16 and its
    analytic curves."""
    fig = json.loads((RESULTS / "fig9_metadata.json").read_text())
    topo = ttopo.partial_mesh(16, 4)
    r = sb.simulate(W.scuttlebutt_gcounter_codec(16), topo, 10, 2,
                    device="cpu")
    m = fig["measured_entries"]["16"]
    assert int(r.meta_tx[0]) == m["per_round"] == m["expected"] \
        == 2 * topo.num_edges * (16 + 16 * 16)
    assert (r.meta_tx == r.meta_tx[0]).all()
    for n, row in fig["analytic"].items():
        assert sb.metadata_bytes_per_node(int(n), 4, 20) == row["scuttlebutt"]
        assert sb.delta_metadata_bytes_per_node(4, 20) == row["delta_based"]
    for args in ((1, 2, 1), (16, 8, 15), (5, 5, 3)):
        assert sb.summary_vector_elems(*args) == jsb.summary_vector_elems(*args)


def test_scatter_max_over_padded_slots():
    """tree(3): the leaves' padded slots repeat node 0 (their parent) with
    a zero update. The port's seen maps equal the JAX package's (whose
    ``.at[].max`` keeps the maximum), and a last-write scatter of the same
    updates would have lost the parent's entry."""
    topo = ttopo.tree(3)
    assert topo.nbrs[1].tolist() == [0, 0] and topo.mask[1].tolist() == \
        [True, False]
    jc, tc = codecs("gcounter", 3)
    got = sb.simulate(tc, topo, 4, 2, device="cpu")
    want = jsb.simulate(jc, jtopo.tree(3), 4, 2)
    assert_same(got, want, "tree3")
    # the round-one update a leaf receives from its parent: a max scatter
    # keeps it, a plain indexed assignment keeps the padded slot's zero
    seen = torch.zeros((3, 3, 3), dtype=torch.int32)
    kv = torch.eye(3, dtype=torch.int32)
    upd = torch.where(topo.mask[:, :, None], kv[topo.nbrs.long()], 0)
    rows = torch.arange(3)[:, None].expand(3, 2)
    last = seen.clone()
    for i in range(3):                      # writes in slot order
        for q in range(2):
            last[i, topo.nbrs[i, q]] = upd[i, q]
    flat = (rows * 3 + topo.nbrs.long()).reshape(-1)[:, None].expand(6, 3)
    amax = seen.reshape(9, 3).scatter_reduce(
        0, flat, upd.reshape(6, 3), reduce="amax",
        include_self=True).reshape(3, 3, 3)
    assert amax[1, 0].tolist() == [1, 0, 0]
    assert not torch.equal(last, amax)


def test_gmap_codec_scales_with_the_block():
    """Every term counts (origin, seq) deltas times ``delta_elems``: the
    GMap codec's tx / mem / max_mem_node are per_node × the GCounter
    codec's (the chip smoke's oracle at 4,194,304 keys), and its final
    states put each origin's sequence number on its key block."""
    topo = ttopo.partial_mesh(15, 4)
    gm = sb.simulate(W.scuttlebutt_gmap_codec(10, 15, 3000), topo, 12, 8,
                     device="cpu")
    gc = sb.simulate(W.scuttlebutt_gcounter_codec(15), topo, 12, 8,
                     device="cpu")
    per = int(W.gmap_key_blocks(15, 3000, 10).sum(1)[0])
    for f in ("tx", "mem", "max_mem_node"):
        np.testing.assert_array_equal(getattr(gm, f), per * getattr(gc, f))
    blocks = torch.as_tensor(W.gmap_key_blocks(15, 3000, 10))
    want = torch.where(blocks.any(0), 12, 0).to(torch.int32).expand(15, 3000)
    assert torch.equal(gm.final_x, want)


def test_runs_on_the_card_by_default():
    """Without ``device=`` the run is on the card, and without one it
    raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.simulate(W.scuttlebutt_gcounter_codec(5), ttopo.ring(5), 2)
