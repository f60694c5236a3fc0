"""The anti-entropy resync modes (``state_driven``, ``digest_driven``), JAX
against the port, and the port against the committed digest results.

* One round: a random carry — states, ``state_driven``'s response buffer,
  ``digest_driven``'s remote digests and have-one flags — goes through one
  ``round_step`` of the JAX reference engine and of each of the port's
  three engines, with and without fault masks; the new carry (``aux``
  included) and the round's metrics must agree exactly.
* Whole runs: both modes on the paper's partial mesh from a divergent start
  (a fresh joiner) plus the GSet workload, without faults and under loss, a
  partition and churn, through JAX ``simulate(..., wide_metrics=False)`` and
  the port's three engines: per-round metrics, ``uniform`` and the final
  states agree exactly.
* Paper size: the port alone reproduces the join table (state, bprr,
  state_driven, digest_driven × divergence 5–75%) and the heal table
  (partition widths 4–16 composed with 2% loss) of
  ``benchmarks/results/fig_digest.json``.
* ``convert``: a carry with ``aux`` crosses to the port and back unchanged.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.sync import DigestSpec as JaxSpec
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import SyncAlgorithm as JaxAlgorithm
from repro.sync import digest as jd
from repro.sync import simulate as jax_simulate
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from repro.sync.faults import RoundFaults as JaxRoundFaults

from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.sync import (ENGINES, RESYNC_ALGORITHMS, DigestSpec,
                              FaultSchedule, SyncAlgorithm, simulate)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW
from repro_torch.sync.faults import RoundFaults

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
N, ACTIVE, QUIET, BE = 15, 6, 6, 8
GROUPS = (np.arange(N) >= N // 2).astype(np.int32)


def both_topos():
    return jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)


# -- one round ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_resync_round(algo, faulted):
    """A random GMap carry (U = 100, off the 8-wide blocks) through one JAX
    round; digests of random states stand in for the remote ones."""
    jtp, _ = both_topos()
    rng = np.random.default_rng(7 + 2 * RESYNC_ALGORITHMS.index(algo)
                                + faulted)
    n, p, u = N, jtp.max_degree, 100

    def state(*shape):
        return (rng.integers(0, 5, size=shape + (u,))
                * (rng.random(shape + (u,)) < 0.4)).astype(np.int32)

    x, delta = state(n), state(n)
    spec = JaxSpec(BE)
    buf = aux = None
    if algo == "state_driven":
        buf = state(n, p)
    else:
        remote = np.array(x[:, None].repeat(p, 1))
        remote[rng.random((n, p, u)) < 0.05] += 1      # a few stale blocks
        aux = (np.asarray(jd.digest_state(jnp.asarray(remote), spec)),
               rng.random((n, p)) < 0.7)
    buf_elems = rng.integers(0, 50, size=n).astype(np.int32)
    rf = views = None
    if faulted:
        link = rng.random((1, n, p)) > 0.3
        up = np.ones((1, n), bool)
        up[0, 4] = False
        v = JaxSchedule(jtp, link, up).views(1)
        rf = JaxRoundFaults(v.recv_ok[0], v.send_ok[0], v.up[0])
        views = tuple(np.asarray(a[0]) for a in v)
    alg = JaxAlgorithm(name=algo, lattice=jtypes.GMap(u).lattice, topo=jtp,
                       digest=spec)
    carry = alg.init(jnp.asarray(x))._replace(
        buf=None if buf is None else jnp.asarray(buf),
        buf_elems=jnp.asarray(buf_elems),
        aux=None if aux is None else tuple(map(jnp.asarray, aux)))
    out, metrics = jax.jit(alg.round_step)(carry, jnp.asarray(delta), rf)
    return ((x, buf, buf_elems, aux, delta, views),
            jax.device_get((out.x, out.buf, out.buf_elems, out.aux)),
            jax.device_get(tuple(metrics)))


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("algo", RESYNC_ALGORITHMS)
@pytest.mark.parametrize("engine", ENGINES)
def test_one_resync_round_matches_jax(algo, engine, faulted):
    (x, buf, buf_elems, aux, delta, views), want_carry, want_metrics = \
        jax_resync_round(algo, faulted)
    _, ttp = both_topos()
    alg = SyncAlgorithm(name=algo, lattice=ttypes.GMap(100).lattice,
                        topo=ttp, engine=engine, metric_dtype=torch.int32,
                        digest=DigestSpec(BE))
    assert alg.resolved_engine == engine
    carry = convert.carry_to_torch(x, buf, buf_elems, aux)
    rf = None if views is None else RoundFaults(*map(convert.to_torch,
                                                     views))
    out, metrics = alg.round_step(carry, convert.to_torch(delta), rf)
    got = convert.carry_to_numpy(out)
    for nm, g, w in zip(("x", "buf", "buf_elems"), got, want_carry):
        if w is None:
            assert g is None, nm
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=nm)
    if want_carry[3] is None:
        assert got[3] is None
    else:
        for nm, g, w in zip(("digests", "have"), got[3], want_carry[3]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=nm)
    for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node"), metrics,
                        want_metrics):
        assert int(g) == int(w), nm


def test_carry_with_aux_crosses_and_comes_back():
    """``aux`` becomes slot-major int32 bit-views and converts back to the
    JAX package's node-major uint32 words unchanged (state_driven's
    response buffer likewise swaps its slot axis)."""
    (x, _, buf_elems, aux, _, _), _, _ = jax_resync_round("digest_driven",
                                                          False)
    carry = convert.carry_to_torch(x, None, buf_elems, aux)
    dig, have = carry.aux
    n, p, nb, c = aux[0].shape
    assert tuple(dig.shape) == (p, n, nb, c) and dig.dtype == torch.int32
    assert tuple(have.shape) == (p, n) and dig.is_contiguous()
    np.testing.assert_array_equal(convert.to_numpy(dig[2], words=True),
                                  aux[0][:, 2])
    back = convert.carry_to_numpy(carry)
    assert back[1] is None
    for g, w in zip(back[3], aux):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    (x, buf, buf_elems, _, _, _), _, _ = jax_resync_round("state_driven",
                                                          False)
    carry = convert.carry_to_torch(x, buf, buf_elems)
    np.testing.assert_array_equal(carry.buf[1].numpy(), buf[:, 1])
    np.testing.assert_array_equal(convert.carry_to_numpy(carry)[1], buf)


# -- whole runs ------------------------------------------------------------------------

def joiner_x0(universe):
    """Every node but node 0 holds the first third of the universe."""
    x0 = np.zeros((N, universe), bool)
    x0[1:, : universe // 3] = True
    return x0


def schedules(F, topo, rounds):
    return {"none": None,
            "loss": F.bernoulli(topo, rounds, 0.2, seed=3),
            "partition": F.partition(topo, rounds, 1, 5, GROUPS),
            "churn": F.churn(topo, rounds, [(0, 1, 4), (N - 2, 2, 7)])}


@functools.lru_cache(maxsize=None)
def jax_resync_run(algo, sched_name):
    jtp, _ = both_topos()
    u = N * ACTIVE
    r = jax_simulate(algo, jtypes.GSet(u).lattice, jtp,
                     jW.gset_unique_op(N, ACTIVE), ACTIVE, QUIET,
                     x0=jnp.asarray(joiner_x0(u)),
                     faults=schedules(JaxSchedule, jtp, ACTIVE)[sched_name],
                     track_convergence=True, digest=JaxSpec(BE),
                     wide_metrics=False)
    return (r.tx, r.mem, r.cpu, r.max_mem_node, r.uniform,
            np.asarray(r.final_x))


@pytest.mark.parametrize("sched_name", ["none", "loss", "partition", "churn"])
@pytest.mark.parametrize("algo", RESYNC_ALGORITHMS)
def test_resync_simulate_matches_jax(algo, sched_name):
    want = jax_resync_run(algo, sched_name)
    _, ttp = both_topos()
    u = N * ACTIVE
    for engine in ENGINES:
        r = simulate(algo, ttypes.GSet(u).lattice, ttp,
                     tW.gset_unique_op(N, ACTIVE), ACTIVE, QUIET,
                     x0=torch.from_numpy(joiner_x0(u)),
                     faults=schedules(FaultSchedule, ttp, ACTIVE)[sched_name],
                     track_convergence=True, digest=DigestSpec(BE),
                     engine=engine, wide_metrics=False, device="cpu")
        for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node", "uniform"),
                            (r.tx, r.mem, r.cpu, r.max_mem_node, r.uniform),
                            want):
            np.testing.assert_array_equal(g, w, err_msg=f"{engine} {nm}")
        np.testing.assert_array_equal(r.final_x.numpy(), want[5],
                                      err_msg=f"{engine} final_x")


@pytest.mark.parametrize("engine", ["fused", "mega"])
def test_kernel_operands_are_contiguous(engine, monkeypatch):
    """The CUDA kernels take contiguous operands only (a plain version on
    the CPU would take any layout): every operand the kernel engines hand
    to a kernel wrapper in faulted resync rounds is contiguous."""
    from repro_torch.kernels import ops

    seen = []

    def guard(fn):
        def wrapped(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), fn.__name__
                    seen.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped

    for name in ("round_recv", "digest_blocks", "masked_extract",
                 "round_step", "buffer_fold"):
        monkeypatch.setattr(ops, name, guard(getattr(ops, name)))
    _, ttp = both_topos()
    sched = schedules(FaultSchedule, ttp, ACTIVE)["loss"].compose(
        schedules(FaultSchedule, ttp, ACTIVE)["churn"])
    u = N * ACTIVE
    for algo in RESYNC_ALGORITHMS + ("bprr", "classic"):
        simulate(algo, ttypes.GSet(u).lattice, ttp,
                 tW.gset_unique_op(N, ACTIVE), ACTIVE, 2,
                 x0=torch.from_numpy(joiner_x0(u)), faults=sched,
                 digest=DigestSpec(BE), engine=engine, device="cpu")
    assert {"round_recv", "digest_blocks", "masked_extract"} <= set(seen)


# -- fig_digest.json from the port alone ---------------------------------------------

FIG = json.loads((RESULTS / "fig_digest.json").read_text())


def fig_topo():
    return ttopo.partial_mesh(FIG["nodes"], 4)


@pytest.mark.parametrize("algo", sorted(FIG["join"]))
def test_fig_digest_join_rows_reproduce(algo):
    """A fresh joiner (node 0 at ⊥) among nodes holding the first r·U
    elements; sync-only rounds."""
    topo, u = fig_topo(), FIG["universe"]
    n = topo.num_nodes
    for key, row in FIG["join"][algo].items():
        x0 = np.zeros((n, u), bool)
        x0[:, : int(round(row["divergence"] * u))] = True
        x0[0] = False
        r = simulate(algo, ttypes.GSet(u).lattice, topo,
                     lambda x, t: torch.zeros_like(x), 0, FIG["rounds"],
                     x0=torch.from_numpy(x0), track_convergence=True,
                     digest=DigestSpec(FIG["block_elems"]), device="cpu")
        conv = r.convergence_round()
        tx_conv = int(r.tx[: conv + 1].sum()) if conv >= 0 else None
        assert (r.total_tx, conv >= 0, conv, tx_conv) == (
            row["tx_window"], row["converged"], row["conv_round"],
            row["tx_to_conv"]), key


@pytest.mark.parametrize("algo", sorted(FIG["heal"]))
def test_fig_digest_heal_rows_reproduce(algo):
    """The GSet workload under a partition of width w (groups n < 7 and
    n ≥ 7) composed with 2% loss (seed 11), 16 events + 32 quiet rounds;
    each width as its own faulted run."""
    topo, events = fig_topo(), FIG["events"]
    n = topo.num_nodes
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    for key, row in FIG["heal"][algo].items():
        w = row["partition_rounds"]
        sched = FaultSchedule.partition(topo, events, 0, w, groups).compose(
            FaultSchedule.bernoulli(topo, events, 0.02, seed=11))
        r = simulate(algo, ttypes.GSet(n * events).lattice, topo,
                     tW.gset_unique_op(n, events), events, 2 * events,
                     faults=sched, digest=DigestSpec(FIG["block_elems"]),
                     device="cpu")
        conv = r.convergence_round()
        assert (r.total_tx, int(r.tx[w:].sum()), conv - events + 1,
                conv >= 0) == (row["tx_total"], row["tx_post_heal"],
                               row["ttc_rounds"], row["converged"]), key
