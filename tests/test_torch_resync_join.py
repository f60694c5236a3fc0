"""A replica rejoining the map at ⊥, healed by the digest-driven resync:
the port against the benchmark's plain reference (``crdtbench/reference``),
on the CPU and without JAX.

* The join: replica 0 starts at ⊥ and every other replica holds a share of
  the 64-key blocks of each 1,024-key tile from a seed-drawn block
  (``crdtbench.traffic.join_start``); 12 ``digest_driven`` rounds on each
  engine give the reference's final states, per-round ``tx``, ``mem``,
  ``cpu`` and ``max_mem_node`` and per-round agreement exactly.
* The Merkle-descent price: ``descent_words``, ``routed_descent_words``
  (the form the resync round takes: pairs of trees, and a topology's
  routes) and the kernel engines' entry (``kernels.ops.merkle_descent``,
  its plain version on the CPU) equal the reference's words on seeded
  random leaves, equal trees and leaf counts that are not a power of two
  included.
* The round's ``torch.profiler`` labels: a digest-driven heal carries
  ``resync.digest``, ``resync.extract``, ``resync.descent`` and
  ``resync.receive`` once a round, ``state_driven`` the last alone, a δ
  run none.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from crdtbench import traffic  # noqa: E402
from crdtbench.reference import crdt  # noqa: E402
from crdtbench.reference import digest as ref_digest  # noqa: E402
from repro_torch.core import GMap  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.sync import (ENGINES, DigestSpec, simulate,  # noqa: E402
                              topology)
from repro_torch.sync import digest as D  # noqa: E402

torch.set_num_threads(1)

NODES, KEYS, TILE, BLOCK, ROUNDS = 15, 4096, 1024, 64, 12
LABELS = ("resync.digest", "resync.extract", "resync.descent",
          "resync.receive")


def no_op(x, t):
    return torch.zeros_like(x)


def join_x0(held: float, seed: int) -> torch.Tensor:
    starts = np.random.default_rng(seed).integers(TILE // BLOCK,
                                                  size=KEYS // TILE)
    return torch.as_tensor(traffic.join_start(NODES, KEYS, TILE, held,
                                              BLOCK, 1, starts))


def heal(algo, engine, x0, keys=KEYS, rounds=ROUNDS):
    return simulate(algo, GMap(keys).lattice,
                    topology.partial_mesh(NODES, 4), no_op, 0, rounds,
                    x0=x0, engine=engine, digest=DigestSpec(BLOCK),
                    track_convergence=True, device="cpu")


@pytest.mark.parametrize("held,seed", [(0.25, 2 ** 31 + 5), (0.75, 17)])
@pytest.mark.parametrize("engine", ENGINES)
def test_join_equals_the_reference(engine, held, seed):
    x0 = join_x0(held, seed)
    res = heal("digest_driven", engine, x0)
    m, x, uni = crdt.run_digest(x0, crdt.mesh_routes(NODES, 4), ROUNDS,
                                BLOCK)
    for i, field in enumerate(("tx", "mem", "cpu", "max_mem_node")):
        np.testing.assert_array_equal(
            np.asarray(getattr(res, field), np.int64), m[i].numpy(),
            err_msg=field)
    assert torch.equal(res.final_x, x)
    np.testing.assert_array_equal(res.uniform, uni.numpy())
    assert bool(uni[-1]) and 0 <= res.convergence_round() < ROUNDS


def random_leaves(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                         dtype=torch.int32)


@pytest.mark.parametrize("nb", [1, 2, 5, 64, 100])
def test_descent_words_equal_the_reference(nb):
    """Pairs of trees (``mine[i]`` against ``theirs[i]``; broadcast; and as
    the rows of one leaf layer routed to each other): equal, one count
    apart, half equal and random."""
    mine = random_leaves((6, nb, 3), nb)
    theirs = random_leaves((6, nb, 3), nb + 1000)
    theirs[0] = mine[0]                          # equal trees
    theirs[1] = mine[1]
    theirs[1, nb // 2, 1] += 1                   # one count differs
    theirs[2, : nb // 2 + 1] = mine[2, : nb // 2 + 1]
    leaf = torch.cat([mine, theirs])
    src = torch.arange(12).roll(6)[None]         # row i against row i ± 6
    want = ref_digest.descent_words(mine, theirs)
    assert torch.equal(D.descent_words(mine, theirs), want)
    assert int(want[0]) == D.CHANNELS
    assert torch.equal(D.descent_words(mine[:, None], theirs[None]),
                       ref_digest.descent_words(mine[:, None], theirs[None]))
    assert torch.equal(D.descent_words(mine, mine),
                       torch.full((6,), D.CHANNELS, dtype=torch.int32))
    got = D.routed_descent_words(leaf, src)
    assert torch.equal(got[0, :6], want)
    assert torch.equal(got[0, 6:], ref_digest.descent_words(theirs, mine))
    assert torch.equal(D.routed_descent_words(leaf, torch.arange(12)[None]),
                       torch.full((1, 12), D.CHANNELS, dtype=torch.int32))


@pytest.mark.parametrize("nb", [1, 3, 64, 100])
def test_routed_descent_equals_the_reference(nb):
    src = topology.partial_mesh(NODES, 4).routes[1]
    leaf = random_leaves((NODES, nb, 3), 7 * nb)
    leaf[3::4] = leaf[0]                         # equal trees among them
    leaf[1, : nb // 2] = leaf[2, : nb // 2]
    want = ref_digest.descent_words(leaf[None], leaf[src])
    assert torch.equal(D.routed_descent_words(leaf, src), want)
    assert torch.equal(D.descent_words(leaf[None], leaf[src]), want)


@pytest.mark.parametrize("nb", [1, 3, 64, 100])
def test_the_descent_kernel_entry_takes_the_plain_version_on_the_cpu(nb):
    """``kernels.ops.merkle_descent`` (the kernel engines' descent) on CPU
    tensors gives the reference's words, and refuses leaves or routes of
    other shapes."""
    src = topology.partial_mesh(NODES, 4).routes[1]
    leaf = random_leaves((NODES, nb, 3), 11 * nb)
    leaf[::5] = leaf[0].clone()
    want = ref_digest.descent_words(leaf[None], leaf[src])
    assert torch.equal(kops.merkle_descent(leaf, src), want)
    with pytest.raises(ValueError):
        kops.merkle_descent(leaf[..., :2], src)
    with pytest.raises(ValueError):
        kops.merkle_descent(leaf, src[:, :-1])


def labels(fn) -> Counter:
    """How often each ``resync.*`` label opens while ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events()
                   if e.name.startswith("resync."))


@pytest.mark.parametrize("engine", ENGINES)
def test_each_resync_label_opens_once_a_round(engine):
    x0 = join_x0(0.25, 3)[:, :1024].contiguous()
    got = labels(lambda: heal("digest_driven", engine, x0, keys=1024))
    assert got == {name: ROUNDS for name in LABELS}
    got = labels(lambda: heal("state_driven", engine, x0, keys=1024))
    assert got == {"resync.receive": ROUNDS}


@pytest.mark.parametrize("engine", ENGINES)
def test_a_delta_run_carries_no_resync_label(engine):
    keys = 1024

    def bump(x, t):
        return torch.where(x < t + 1, t + 1, 0).to(x.dtype)

    got = labels(lambda: simulate(
        "bprr", GMap(keys).lattice, topology.partial_mesh(NODES, 4), bump,
        ROUNDS // 2, ROUNDS // 2, engine=engine, device="cpu"))
    assert not got
