"""The sweep engine, JAX against the port.

* Every cell of a port ``simulate_sweep`` equals the JAX package's
  ``simulate_sweep(..., wide_metrics=False)`` cell exactly — final states,
  per-round tx / mem / cpu / max_mem_node, ``uniform`` and convergence —
  for every algorithm (the resync modes included) on each of the port's
  three engines, fault-free and with per-cell fault schedules. The JAX
  side runs its reference engine (its three engines are bit-identical, as
  its own tests hold), and once on ``fused`` for the packed bitor kind.
* ``res.cell(b)`` equals the port's own single ``simulate`` of that cell.
* Stacked initial states, ``stack_op``, the mixed-rank linear sum, the
  spec's validation, the option that waits for a later slice (shard)
  and the refusal of a malformed observability argument.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GSet as JGSet
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import SweepSpec as JaxSweepSpec
from repro.sync import simulate_sweep as jax_simulate_sweep
from repro.sync import topology as jtopo
from repro.sync import workloads as jW

from test_sweep import _linsum_workload as jax_linsum_workload
from test_sweep import bitgset_sweep_ops as jax_bitgset_sweep_ops

from repro_torch.core import BitGSet, GSet, MapLattice, linear_sum, tree_leaves
from repro_torch.core import value_lattices as tvl
from repro_torch.sync import (ALGORITHMS, ENGINES, FaultSchedule, SweepSpec,
                              converged, simulate, simulate_sweep)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

N, T, Q, B = 7, 5, 8, 3
SEEDS = (0, 3, 11)
GROUPS = (np.arange(N) >= N // 2).astype(np.int32)


def fault_mix(F, topo):
    """Per-cell schedules of either package: fault-free, lossy, and loss ∘
    partition ∘ churn."""
    composite = F.bernoulli(topo, T, 0.2, seed=2).compose(
        F.partition(topo, T, 1, T - 1, GROUPS)).compose(
        F.churn(topo, T, [(N // 2, 1, T - 1)]))
    return [None, F.bernoulli(topo, T, 0.3, seed=7), composite]


def np_leaves(state, words=False):
    """A state's leaves (torch or JAX) as numpy arrays; ``words`` shows the
    port's int32 bit-views as the JAX package's uint32 words."""
    out = []
    for a in tree_leaves(state):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
            a = a.view(np.uint32) if words else a
        out.append(np.asarray(a))
    return out


def assert_same_run(got, want, ctx, words=False):
    """A port result (or cell) against a JAX or port one: final states,
    the four metrics and ``uniform``, exactly."""
    gx, wx = np_leaves(got.final_x, words), np_leaves(want.final_x, words)
    assert len(gx) == len(wx), ctx
    for g, w in zip(gx, wx):
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx}: final state")
    for f in ("tx", "mem", "cpu", "max_mem_node"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx}: {f}")
    if want.uniform is None:
        assert got.uniform is None, ctx
    else:
        np.testing.assert_array_equal(got.uniform, np.asarray(want.uniform),
                                      err_msg=f"{ctx}: uniform")


def topos():
    return jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)


@functools.lru_cache(maxsize=None)
def jax_sweep(algo, faulted):
    jtp, _ = topos()
    spec = JaxSweepSpec(batch=B, op_fn=jW.gset_unique_sweep_op(N, T, SEEDS),
                        faults=fault_mix(JaxSchedule, jtp) if faulted
                        else None)
    return jax_simulate_sweep(algo, JGSet(N * T).lattice, jtp, spec,
                              active_rounds=T, quiet_rounds=Q,
                              wide_metrics=False)


def port_sweep(algo, engine, faulted):
    _, ttp = topos()
    spec = SweepSpec(batch=B, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS),
                     faults=fault_mix(FaultSchedule, ttp) if faulted
                     else None)
    return simulate_sweep(algo, GSet(N * T).lattice, ttp, spec,
                          active_rounds=T, quiet_rounds=Q, engine=engine,
                          device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faulted", [False, True], ids=["fault_free",
                                                         "faulted"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_sweep_cells_match_jax(algo, faulted, engine):
    want = jax_sweep(algo, faulted)
    got = port_sweep(algo, engine, faulted)
    assert got.batch == B and got.tx.shape == (B, T + Q)
    _, ttp = topos()
    scheds = fault_mix(FaultSchedule, ttp) if faulted else [None] * B
    for b, seed in enumerate(SEEDS):
        assert_same_run(got.cell(b), want.cell(b),
                        f"{algo}/{engine}/faulted={faulted}/cell{b}")
        single = simulate(algo, GSet(N * T).lattice, ttp,
                          tW.gset_unique_op(N, T, seed), T, Q, engine=engine,
                          faults=scheds[b], device="cpu",
                          track_convergence=faulted)
        assert_same_run(got.cell(b), single, f"{algo}/{engine}/single{b}")
    if faulted:
        np.testing.assert_array_equal(got.convergence_round(),
                                      want.convergence_round())
        assert (got.convergence_round() >= 0).all()


def bitgset_ops(n=N, rounds=T):
    """The port's unique-element stream on a BitGSet: single-run and
    batched ops (``test_sweep.bitgset_sweep_ops`` on the JAX side)."""
    bg = BitGSet(universe=n * rounds)

    def mask(lead, t):
        ids = np.arange(n) * rounds + min(t, rounds - 1)
        m = np.zeros(lead + (n, bg.num_words), np.uint32)
        m[..., np.arange(n), ids // 32] = np.uint32(1) << (ids % 32).astype(
            np.uint32)
        return torch.from_numpy(m.view(np.int32))

    def cell(x, t):
        return bg.add_mask_delta(x, mask((), t))

    def sweep(x, t):
        return bg.add_mask_delta(x, mask((x.shape[0],), t))

    return bg.lattice, cell, sweep


@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_bitor_kernel_kind(engine):
    """The packed bitor kind through the batch, against the JAX fused
    engine (its Pallas kernels in interpret mode)."""
    jlat, _, jsweep = jax_bitgset_sweep_ops()
    tlat, tcell, tsweep = bitgset_ops()
    want = jax_simulate_sweep("bprr", jlat, jtopo.tree(N),
                              JaxSweepSpec(batch=2, op_fn=jsweep),
                              active_rounds=T, quiet_rounds=Q,
                              engine="fused", wide_metrics=False)
    got = simulate_sweep("bprr", tlat, ttopo.tree(N),
                         SweepSpec(batch=2, op_fn=tsweep), T, Q,
                         engine=engine, device="cpu")
    single = simulate("bprr", tlat, ttopo.tree(N), tcell, T, Q,
                      engine=engine, device="cpu")
    for b in range(2):
        assert_same_run(got.cell(b), want.cell(b), f"bitgset/{engine}/{b}",
                        words=True)
        assert_same_run(got.cell(b), single, f"bitgset/{engine}/single{b}")


def linsum_ops(n=N, side=4):
    """The port's linear sum of two max-maps (a rank-0 tag leaf beside [U]
    sides): nodes inflate the low side early, then jump to the high side
    (``test_sweep._linsum_workload`` on the JAX side)."""
    lat = linear_sum("linsum", MapLattice(side, tvl.max_int(), "lo").build(),
                     MapLattice(side, tvl.max_int(), "hi").build())

    def cell(x, t):
        tags = torch.full((n,), 1 if t >= 2 else 0, dtype=torch.int32)
        lo = torch.zeros((n, side), dtype=torch.int32)
        lo[:, 0] = t + 1 if t < 2 else 0
        hi = torch.zeros((n, side), dtype=torch.int32)
        hi[:, 1] = t + 1 if t >= 2 else 0
        return (tags, lo, hi)

    def sweep(x, t):
        b = x[0].shape[0]
        return tuple(a.expand((b,) + tuple(a.shape)).clone()
                     for a in cell(None, t))

    return lat, cell, sweep


@pytest.mark.parametrize("algo", ["state", "bprr"])
def test_linsum_mixed_rank_leaves(algo):
    jlat, _, jsweep = jax_linsum_workload()
    tlat, tcell, tsweep = linsum_ops()
    want = jax_simulate_sweep(algo, jlat, jtopo.ring(N),
                              JaxSweepSpec(batch=2, op_fn=jsweep),
                              active_rounds=T, quiet_rounds=Q,
                              wide_metrics=False)
    got = simulate_sweep(algo, tlat, ttopo.ring(N),
                         SweepSpec(batch=2, op_fn=tsweep), T, Q,
                         device="cpu")
    single = simulate(algo, tlat, ttopo.ring(N), tcell, T, Q, device="cpu")
    assert converged(tlat, single.final_x)
    for b in range(2):
        assert_same_run(got.cell(b), want.cell(b), f"linsum/{algo}/{b}")
        assert_same_run(got.cell(b), single, f"linsum/{algo}/single{b}")


def stacked_x0():
    cells = []
    for b in range(B):
        x0 = np.zeros((N, N * T), bool)
        x0[0, :b + 1] = True              # node 0 pre-seeded differently
        cells.append(x0)
    return cells


def test_sweep_stacked_x0():
    jtp, ttp = topos()
    cells = stacked_x0()
    want = jax_simulate_sweep(
        "bprr", JGSet(N * T).lattice, jtp,
        JaxSweepSpec(batch=B, op_fn=jW.gset_unique_sweep_op(N, T, SEEDS),
                     x0=jnp.asarray(np.stack(cells))),
        active_rounds=T, quiet_rounds=Q, wide_metrics=False)
    got = simulate_sweep(
        "bprr", GSet(N * T).lattice, ttp,
        SweepSpec(batch=B, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS),
                  x0=np.stack(cells)), T, Q, device="cpu")
    for b in range(B):
        assert_same_run(got.cell(b), want.cell(b), f"x0/cell{b}")
        single = simulate("bprr", GSet(N * T).lattice, ttp,
                          tW.gset_unique_op(N, T, SEEDS[b]), T, Q,
                          x0=torch.from_numpy(cells[b]), device="cpu")
        assert_same_run(got.cell(b), single, f"x0/single{b}")


def test_stack_op_lifts_single_ops():
    _, ttp = topos()
    lat = GSet(N * T).lattice
    op = SweepSpec.stack_op([tW.gset_unique_op(N, T, s) for s in SEEDS])
    got = simulate_sweep("rr", lat, ttp, SweepSpec(batch=B, op_fn=op), T, Q,
                         device="cpu")
    want = port_sweep("rr", "reference", False)
    for b in range(B):
        assert_same_run(got.cell(b), want.cell(b), f"stack_op/cell{b}")


def test_sweep_spec_validation_and_unported_options():
    _, ttp = topos()
    lat = GSet(N * T).lattice
    with pytest.raises(ValueError):
        SweepSpec(batch=0, op_fn=lambda x, t: x)
    with pytest.raises(ValueError):
        SweepSpec(batch=3, op_fn=lambda x, t: x, faults=[None, None])
    spec = SweepSpec(batch=2, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS[:2]),
                     faults=[None, FaultSchedule.none(ttopo.tree(N), T)])
    with pytest.raises(ValueError):           # schedule bound to other topo
        simulate_sweep("bprr", lat, ttp, spec, T, device="cpu")
    ok = SweepSpec(batch=2, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS[:2]))
    with pytest.raises(ValueError, match="not divisible"):
        simulate_sweep("bprr", lat, ttp, ok, T, shard=True,
                       device=["cpu"] * 4)
    with pytest.raises(ValueError, match="shard=True"):
        simulate_sweep("bprr", lat, ttp, ok, T, device=["cpu"] * 2)
    stacked = SweepSpec(batch=2, op_fn=SweepSpec.stack_op(
        [tW.gset_unique_op(N, T, s) for s in SEEDS[:2]]))
    assert_same_run(
        simulate_sweep("bprr", lat, ttp, stacked, T, shard=True,
                       device=["cpu"] * 2),
        simulate_sweep("bprr", lat, ttp, stacked, T, device="cpu"),
        "stack_op over two blocks")
    # over several blocks, an op_fn that closes over [B] tables is refused
    # before anything runs; one block may close over them
    table = torch.zeros((2, N, N * T), dtype=torch.bool)
    closed = SweepSpec(batch=2, op_fn=lambda x, t: x | table)
    with pytest.raises(ValueError, match="sharded config axis"):
        simulate_sweep("bprr", lat, ttp, closed, T, shard=True,
                       device=["cpu"] * 2)
    simulate_sweep("bprr", lat, ttp, closed, T, shard=True, device=["cpu"])
    for kw in ({"telemetry": object()}, {"provenance": object()}):
        with pytest.raises(TypeError):
            simulate_sweep("bprr", lat, ttp, ok, T, device="cpu", **kw)
    single = simulate("bprr", lat, ttp, tW.gset_unique_op(N, T), T,
                      device="cpu")
    assert single.batch is None
    with pytest.raises(ValueError):
        single.cell(0)


# -- one batched round, carry by carry ------------------------------------------

def random_batched_carry(algo, rng, p, u, nb_blocks):
    """A JAX-layout batched carry (numpy) with random states, buffers,
    entry counts and digests."""

    def bits(*shape):
        return rng.integers(0, 2, size=shape).astype(bool)

    x = bits(B, N, u)
    buf = aux = None
    if algo in ("bp", "bprr"):
        buf = bits(B, N, p + 1, u)
    elif algo in ("classic", "rr"):
        buf = bits(B, N, u)
    elif algo == "state_driven":
        buf = bits(B, N, p, u)
    if algo == "digest_driven":
        aux = (rng.integers(0, 2**32, size=(B, N, p, nb_blocks, 3),
                            dtype=np.uint32), bits(B, N, p))
    elems = rng.integers(0, 9, size=(B, N)).astype(np.int32)
    return x, buf, elems, aux


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_one_batched_round_matches_jax(algo, engine):
    """A random batched carry under random per-config fault masks through
    one JAX ``round_step`` (reference) and one of the port's (``convert``
    moving the carry across in the batched layouts): the new carry and
    the per-config metrics agree exactly."""
    from repro.sync import DigestSpec as JaxDigestSpec
    from repro.sync import SyncAlgorithm as JaxAlgorithm
    from repro.sync.algorithms import AlgoCarry as JaxCarry
    from repro.sync.faults import RoundFaults as JaxRoundFaults

    from repro_torch import convert
    from repro_torch.sync import DigestSpec, SyncAlgorithm
    from repro_torch.sync.faults import RoundFaults

    jtp, ttp = topos()
    p, u, be = jtp.max_degree, 24, 8
    rng = np.random.default_rng(ALGORITHMS.index(algo))
    x, buf, elems, aux = random_batched_carry(algo, rng, p, u, u // be)
    delta = rng.integers(0, 2, size=(B, N, u)).astype(bool)
    recv_ok = rng.random((B, N, p)) > 0.2
    send_ok = rng.random((B, N, p)) > 0.2
    up = rng.random((B, N)) > 0.1

    jalg = JaxAlgorithm(algo, JGSet(u).lattice, jtp, batch=B,
                        digest=JaxDigestSpec(be))
    jcarry = JaxCarry(x=jnp.asarray(x),
                      buf=None if buf is None else jnp.asarray(buf),
                      buf_elems=jnp.asarray(elems),
                      aux=None if aux is None else tuple(
                          jnp.asarray(a) for a in aux))
    jout, jm = jalg.round_step(
        jcarry, jnp.asarray(delta & up[..., None]),
        JaxRoundFaults(jnp.asarray(recv_ok), jnp.asarray(send_ok),
                       jnp.asarray(up)))

    talg = SyncAlgorithm(algo, GSet(u).lattice, ttp, engine=engine,
                         metric_dtype=torch.int32, digest=DigestSpec(be),
                         batch=B)
    tcarry = convert.carry_to_torch(x, buf, elems, aux, batched=True)
    tout, tm = talg.round_step(
        tcarry, torch.from_numpy(delta & up[..., None]),
        RoundFaults(*(torch.from_numpy(a) for a in (recv_ok, send_ok, up))))

    got = convert.carry_to_numpy(tout, batched=True)
    want = (jout.x, jout.buf, jout.buf_elems, jout.aux)
    for name, g, w in zip(("x", "buf", "buf_elems"), got[:3], want[:3]):
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    if want[3] is not None:
        for g, w in zip(got[3], want[3]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg="aux")
    for f in ("tx", "mem", "cpu", "max_mem_node"):
        g, w = getattr(tm, f).numpy(), np.asarray(getattr(jm, f))
        assert g.shape == (B,), f
        np.testing.assert_array_equal(g, w, err_msg=f)
