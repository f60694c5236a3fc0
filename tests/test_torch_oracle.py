"""The observability oracles, JAX against the port.

For every case, three things are exactly equal (tolerance 0: every channel
is an integer tally or a round index):

* the port's ``oracle_channels`` / ``oracle_provenance`` on the CPU;
* the JAX package's ``repro.obs.oracle`` on the same inputs (the JAX
  oracle is an unjitted replay, so it runs under JAX 0.9.0 where the JAX
  ``simulate`` needs ``wide_metrics=False``);
* the port's in-scan channels of ``simulate(..., telemetry=,
  provenance=)`` on each of the ``reference``, ``fused`` and ``mega``
  engines.

The cases cover all seven algorithms; GSet, GCounter, BitGSet (its
universe trimmed) and LWWMap (channels only: both packages refuse
provenance on its tuple state with the same error); fault-free runs, the
JAX tests' loss + churn (Bernoulli 25% ∘ node 2 down in rounds 2-4) and a
partition; a joining replica's ``x0`` for the resync modes; disabled spec
groups; zero rounds; and a property sweep when ``hypothesis`` is
installed. An independence test runs the oracles with the kernels, the
engines' telemetry channels and the provenance replay patched to raise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import types as jtypes
from repro.obs import ProvenanceSpec as JaxProvenanceSpec
from repro.obs import TelemetrySpec as JaxTelemetrySpec
from repro.obs import oracle as joracle
from repro.sync import DigestSpec as JaxDigestSpec
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from test_torch_simulate import jax_bitgset_op

from repro_torch import kernels
from repro_torch.core import types as ttypes
from repro_torch.kernels import ops as kops
from repro_torch.obs import (ProvenanceResult, ProvenanceSpec,
                             TelemetryResult, TelemetrySpec)
from repro_torch.obs import oracle
from repro_torch.obs import provenance as prv
from repro_torch.obs import telemetry as tel
from repro_torch.sync import (ALGORITHMS, ENGINES, DigestSpec, FaultSchedule,
                              simulate)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

N, EVENTS, ACTIVE, QUIET, STRIDE = 9, 4, 4, 5, 3
KEYS, BE = 24, 8
TOTAL = ACTIVE + QUIET
TELE = TelemetryResult._fields[:6]
PROV = ProvenanceResult._fields[:11]
JOIN_U = 64


def lww_tables(seed=0):
    """Each node writes two keys a round: keys, values from ``seed``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, KEYS, size=(ACTIVE, N, 2))
    vals = rng.integers(-3, 4, size=(ACTIVE, N, 2)).astype(np.int32)
    return keys, vals


def jax_lww_op(seed=0):
    keys, vals = (jnp.asarray(a) for a in lww_tables(seed))
    rows = jnp.stack([jnp.arange(N)] * 2, 1)

    def op_fn(x, t):
        ts, v = x
        i = jnp.minimum(t, ACTIVE - 1)
        k = keys[i]
        dt = jnp.zeros_like(ts).at[rows, k].set(ts[rows, k] + 1)
        dv = jnp.zeros_like(v).at[rows, k].set(vals[i])
        return (dt, dv)

    return op_fn


def torch_lww_op(seed=0):
    keys, vals = lww_tables(seed)

    def op_fn(x, t):
        ts, v = x
        rows = torch.arange(N, device=ts.device)[:, None].expand(N, 2)
        k = torch.as_tensor(keys[min(t, ACTIVE - 1)], device=ts.device)
        dt, dv = torch.zeros_like(ts), torch.zeros_like(v)
        dt[rows, k] = ts[rows, k] + 1
        dv[rows, k] = torch.as_tensor(vals[min(t, ACTIVE - 1)],
                                      device=v.device)
        return (dt, dv)

    return op_fn


def workload(name):
    """(JAX lattice, JAX op, port lattice, port op, universe=)."""
    if name == "gset":
        return (jtypes.GSet(N * EVENTS).lattice, jW.gset_unique_op(N, EVENTS),
                ttypes.GSet(N * EVENTS).lattice,
                tW.gset_unique_op(N, EVENTS), None)
    if name == "gcounter":
        return (jtypes.GCounter(N).lattice, jW.gcounter_op(N),
                ttypes.GCounter(N).lattice, tW.gcounter_op(N), None)
    if name == "bitgset":
        u = N * EVENTS * STRIDE
        return (jtypes.BitGSet(u).lattice, jax_bitgset_op(N, EVENTS, STRIDE),
                ttypes.BitGSet(u).lattice,
                tW.bitgset_unique_op(N, EVENTS, STRIDE), u)
    return (jtypes.LWWMap(KEYS).lattice, jax_lww_op(),
            ttypes.LWWMap(KEYS).lattice, torch_lww_op(), None)


def topos(name="mesh"):
    return jtopo.by_name(name, N, 4), ttopo.by_name(name, N, 4)


def schedule(F, topo, kind, seed=7):
    """None, the JAX tests' loss + churn, or a two-sided partition in
    rounds [1, 6)."""
    if kind == "none":
        return None
    if kind == "loss_churn":
        return F.bernoulli(topo, TOTAL, 0.25, seed=seed).compose(
            F.churn(topo, TOTAL, [(2, 2, 5)]))
    return F.partition(topo, TOTAL, 1, 6, [0] * (N // 2) + [1] * (N - N // 2))


def assert_tele_equal(got, want, ctx):
    assert isinstance(got, TelemetryResult), ctx
    for f in TELE:
        g = getattr(got, f)
        assert g.dtype == np.int32 and g.shape == (TOTAL, N), (ctx, f, g.shape)
        np.testing.assert_array_equal(g, np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx}: {f}")


def assert_prov_equal(got, want, ctx):
    assert isinstance(got, ProvenanceResult), ctx
    got = got.numpy()
    for f in PROV:
        w = getattr(want, f)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(getattr(got, f), w,
                                      err_msg=f"{ctx}: {f}")
    assert got.cov.dtype == np.int32 and got.waste_bp.dtype == np.int32


def jax_kw(faults, x0=None):
    kw = dict(faults=faults, digest=JaxDigestSpec(BE))
    if x0 is not None:
        kw["x0"] = jnp.asarray(x0)
    return kw


def port_kw(faults, x0=None):
    kw = dict(faults=faults, digest=DigestSpec(BE))
    if x0 is not None:
        kw["x0"] = torch.as_tensor(x0)
    return kw


@functools.lru_cache(maxsize=None)
def jax_oracles(algo, lat_name, fault, prov=True):
    jlat, jop, _, _, u = workload(lat_name)
    jtp, _ = topos()
    kw = jax_kw(schedule(JaxSchedule, jtp, fault))
    ch = joracle.oracle_channels(algo, jlat, jtp, jop, ACTIVE, QUIET, **kw)
    pv = joracle.oracle_provenance(algo, jlat, jtp, jop, ACTIVE, QUIET,
                                   spec=JaxProvenanceSpec(universe=u),
                                   **kw) if prov else None
    return ch, pv


def check_case(algo, lat_name, fault):
    """Port oracle (CPU) = JAX oracle = in-scan channels on three
    engines."""
    _, _, tlat, top, u = workload(lat_name)
    _, ttp = topos()
    prov = lat_name != "lww"
    want_ch, want_pv = jax_oracles(algo, lat_name, fault, prov)
    kw = port_kw(schedule(FaultSchedule, ttp, fault))
    ctx = f"{algo}/{lat_name}/{fault}"
    got_ch = oracle.oracle_channels(algo, tlat, ttp, top, ACTIVE, QUIET,
                                    device="cpu", **kw)
    assert_tele_equal(got_ch, want_ch, f"{ctx}: oracle")
    spec = ProvenanceSpec(universe=u) if prov else None
    if prov:
        got_pv = oracle.oracle_provenance(algo, tlat, ttp, top, ACTIVE,
                                          QUIET, spec=spec, device="cpu",
                                          **kw)
        assert_prov_equal(got_pv, want_pv, f"{ctx}: oracle")
    for engine in ENGINES:
        r = simulate(algo, tlat, ttp, top, ACTIVE, QUIET, engine=engine,
                     telemetry=TelemetrySpec(), provenance=spec,
                     device="cpu", **kw)
        assert_tele_equal(r.telemetry, got_ch, f"{ctx}: {engine}")
        if prov:
            assert_prov_equal(r.provenance, got_pv, f"{ctx}: {engine}")


# -- the oracle property ----------------------------------------------------------

CASES = [("gset", "none"), ("gcounter", "partition"), ("bitgset", "loss_churn")]


@pytest.mark.parametrize("lat_name,fault", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_oracles_match_jax_and_engines(algo, lat_name, fault):
    check_case(algo, lat_name, fault)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_lww_channels_match_jax_and_engines(algo):
    """Tuple (lex-pair) states: channels only, through the reference
    fallback on every engine."""
    check_case(algo, "lww", "loss_churn")


def test_lww_provenance_is_refused_alike():
    jlat, jop, tlat, top, _ = workload("lww")
    jtp, ttp = topos()
    with pytest.raises(ValueError) as jerr:
        joracle.oracle_provenance("bprr", jlat, jtp, jop, ACTIVE, QUIET)
    with pytest.raises(ValueError) as terr:
        oracle.oracle_provenance("bprr", tlat, ttp, top, ACTIVE, QUIET,
                                 device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "tuple state" in str(terr.value)


def joiner_x0(seed=5):
    """Every node but node 0 holds a random ~quarter of the universe."""
    x0 = np.random.default_rng(seed).random((N, JOIN_U)) < 0.25
    x0[0] = False
    return x0


@pytest.mark.parametrize("algo", ["state_driven", "digest_driven", "bprr"])
def test_joining_replica_matches(algo):
    """A joining replica under loss + churn, no ops: the initial states
    count as native (birth −1, src its node, hop 0)."""
    x0 = joiner_x0()
    jtp, ttp = topos()
    jlat, tlat = jtypes.GSet(JOIN_U).lattice, ttypes.GSet(JOIN_U).lattice
    jkw = jax_kw(schedule(JaxSchedule, jtp, "loss_churn"), x0)
    tkw = port_kw(schedule(FaultSchedule, ttp, "loss_churn"), x0)
    jop = lambda x, t: jnp.zeros_like(x)        # noqa: E731
    top = lambda x, t: torch.zeros_like(x)      # noqa: E731
    want_ch = joracle.oracle_channels(algo, jlat, jtp, jop, 0, TOTAL, **jkw)
    want_pv = joracle.oracle_provenance(algo, jlat, jtp, jop, 0, TOTAL,
                                        **jkw)
    got_ch = oracle.oracle_channels(algo, tlat, ttp, top, 0, TOTAL,
                                    device="cpu", **tkw)
    got_pv = oracle.oracle_provenance(algo, tlat, ttp, top, 0, TOTAL,
                                      device="cpu", **tkw)
    assert_tele_equal(got_ch, want_ch, algo)
    assert_prov_equal(got_pv, want_pv, algo)
    assert (got_pv.numpy().hop[x0] == 0).all()
    assert (got_pv.numpy().birth[x0] == -1).all()
    for engine in ENGINES:
        r = simulate(algo, tlat, ttp, top, 0, TOTAL, engine=engine,
                     telemetry=TelemetrySpec(), provenance=ProvenanceSpec(),
                     device="cpu", **tkw)
        assert_tele_equal(r.telemetry, got_ch, f"{algo}/{engine}")
        assert_prov_equal(r.provenance, got_pv, f"{algo}/{engine}")


SPECS = [dict(redundancy=False), dict(staleness=False), dict(buffer=False),
         dict(divergence=False),
         dict(redundancy=False, staleness=False, buffer=False,
              divergence=False)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(s))
def test_disabled_telemetry_groups(spec):
    """A disabled group comes back as zeros on both oracles and every
    engine; the enabled ones are unchanged."""
    jlat, jop, tlat, top, _ = workload("gcounter")
    jtp, ttp = topos()
    want = joracle.oracle_channels(
        "bp", jlat, jtp, jop, ACTIVE, QUIET,
        spec=JaxTelemetrySpec(**spec),
        **jax_kw(schedule(JaxSchedule, jtp, "loss_churn")))
    kw = port_kw(schedule(FaultSchedule, ttp, "loss_churn"))
    got = oracle.oracle_channels("bp", tlat, ttp, top, ACTIVE, QUIET,
                                 spec=TelemetrySpec(**spec), device="cpu",
                                 **kw)
    assert_tele_equal(got, want, str(spec))
    full, _ = jax_oracles("bp", "gcounter", "loss_churn", False)
    groups = {"redundancy": ("recv_elems", "novel_elems"),
              "staleness": ("stale_rounds",),
              "buffer": ("ack_lag", "buf_elems"), "divergence": ("div_gap",)}
    for g, fields in groups.items():
        for f in fields:
            want_f = np.zeros_like(got.recv_elems) if g in spec \
                else getattr(full, f)
            np.testing.assert_array_equal(getattr(got, f), want_f,
                                          err_msg=f"{spec}: {f}")
    for engine in ENGINES:
        r = simulate("bp", tlat, ttp, top, ACTIVE, QUIET, engine=engine,
                     telemetry=TelemetrySpec(**spec), device="cpu", **kw)
        assert_tele_equal(r.telemetry, got, f"{spec}/{engine}")


@pytest.mark.parametrize("spec", [dict(edges=False), dict(waste=False)],
                         ids=["no_edges", "no_waste"])
def test_disabled_provenance_groups(spec):
    jlat, jop, tlat, top, u = workload("bitgset")
    jtp, ttp = topos()
    want = joracle.oracle_provenance(
        "classic", jlat, jtp, jop, ACTIVE, QUIET,
        spec=JaxProvenanceSpec(universe=u, **spec),
        **jax_kw(schedule(JaxSchedule, jtp, "loss_churn")))
    kw = port_kw(schedule(FaultSchedule, ttp, "loss_churn"))
    pspec = ProvenanceSpec(universe=u, **spec)
    got = oracle.oracle_provenance("classic", tlat, ttp, top, ACTIVE, QUIET,
                                   spec=pspec, device="cpu", **kw)
    assert_prov_equal(got, want, str(spec))
    if "edges" in spec:
        assert (got.numpy().edge_first == -1).all()
    else:
        assert not got.waste_bp.any() and not got.numpy().waste_cp_elems.any()
    for engine in ENGINES:
        r = simulate("classic", tlat, ttp, top, ACTIVE, QUIET, engine=engine,
                     provenance=pspec, device="cpu", **kw)
        assert_prov_equal(r.provenance, got, f"{spec}/{engine}")


def test_zero_rounds():
    """No rounds: empty [0, N] channels and the initial lineage, as the
    engines give them (the JAX ``oracle_channels`` cannot stack zero
    rounds; its ``oracle_provenance`` can)."""
    jlat, jop, tlat, top, _ = workload("gset")
    jtp, ttp = topos()
    want = joracle.oracle_provenance("bprr", jlat, jtp, jop, 0, 0)
    got = oracle.oracle_provenance("bprr", tlat, ttp, top, 0, 0,
                                   device="cpu")
    assert_prov_equal(got, want, "zero rounds")
    assert got.covered.shape == (0, N)
    ch = oracle.oracle_channels("bprr", tlat, ttp, top, 0, 0, device="cpu")
    r = simulate("bprr", tlat, ttp, top, 0, 0, telemetry=TelemetrySpec(),
                 device="cpu")
    for f in TELE:
        assert getattr(ch, f).shape == (0, N) == getattr(r.telemetry, f).shape


@settings(max_examples=10, deadline=None)
@given(data=st.data())
def test_oracles_match_property(data):
    """Hypothesis sweep: algorithm × lattice × topology × engine × fault
    seed, the port oracle against the JAX oracle and one engine."""
    algo = data.draw(st.sampled_from(ALGORITHMS), label="algo")
    lat_name = data.draw(st.sampled_from(["gset", "gcounter", "bitgset",
                                          "lww"]), label="lattice")
    tname = data.draw(st.sampled_from(["mesh", "tree", "full", "ring"]),
                      label="topology")
    engine = data.draw(st.sampled_from(ENGINES), label="engine")
    seed = data.draw(st.integers(0, 2**16), label="seed")
    fault = data.draw(st.sampled_from(["none", "loss_churn", "partition"]),
                      label="faults")
    jlat, jop, tlat, top, u = workload(lat_name)
    jtp, ttp = topos(tname)
    jkw = jax_kw(schedule(JaxSchedule, jtp, fault, seed))
    tkw = port_kw(schedule(FaultSchedule, ttp, fault, seed))
    ctx = f"{algo}/{lat_name}/{tname}/{engine}/{fault}/seed{seed}"
    prov = lat_name != "lww"
    spec = ProvenanceSpec(universe=u) if prov else None
    got = oracle.oracle_channels(algo, tlat, ttp, top, ACTIVE, QUIET,
                                 device="cpu", **tkw)
    assert_tele_equal(got, joracle.oracle_channels(
        algo, jlat, jtp, jop, ACTIVE, QUIET, **jkw), ctx)
    r = simulate(algo, tlat, ttp, top, ACTIVE, QUIET, engine=engine,
                 telemetry=TelemetrySpec(), provenance=spec, device="cpu",
                 **tkw)
    assert_tele_equal(r.telemetry, got, ctx)
    if prov:
        got_pv = oracle.oracle_provenance(algo, tlat, ttp, top, ACTIVE,
                                          QUIET, spec=spec, device="cpu",
                                          **tkw)
        assert_prov_equal(got_pv, joracle.oracle_provenance(
            algo, jlat, jtp, jop, ACTIVE, QUIET,
            spec=JaxProvenanceSpec(universe=u), **jkw), ctx)
        assert_prov_equal(r.provenance, got_pv, ctx)


# -- independence ----------------------------------------------------------------

def _raises(name):
    def f(*a, **k):
        raise AssertionError(f"{name} was called")

    return f


@pytest.mark.parametrize("algo,lat_name", [("bprr", "bitgset"),
                                           ("digest_driven", "gset"),
                                           ("state_driven", "gcounter")])
def test_oracles_share_no_channel_code(algo, lat_name, monkeypatch):
    """With every kernel wrapper and entry point, telemetry's channel code
    and provenance's replay patched to raise, the oracles still return
    the JAX oracle's result."""
    _, _, tlat, top, u = workload(lat_name)
    _, ttp = topos()
    for mod in list(kernels.KERNELS.values()) + [kops]:
        for name, fn in list(vars(mod).items()):
            if callable(fn) and getattr(fn, "__module__", None) \
                    == mod.__name__ and not isinstance(fn, type):
                monkeypatch.setattr(mod, name, _raises(f"{mod.__name__}."
                                                       f"{name}"))
    for mod, names in ((tel, ("round_channels", "cluster_gap",
                              "_cluster_join", "init_carry")),
                       (prv, ("round_update", "_unpack_bits", "_elem_mask",
                              "_novel_elem_mask", "init_carry"))):
        for name in names:
            monkeypatch.setattr(mod, name, _raises(f"{mod.__name__}.{name}"))
    kw = port_kw(schedule(FaultSchedule, ttp, "loss_churn"))
    got_ch = oracle.oracle_channels(algo, tlat, ttp, top, ACTIVE, QUIET,
                                    device="cpu", **kw)
    got_pv = oracle.oracle_provenance(algo, tlat, ttp, top, ACTIVE, QUIET,
                                      spec=ProvenanceSpec(universe=u),
                                      device="cpu", **kw)
    with pytest.raises(AssertionError, match="was called"):
        simulate(algo, tlat, ttp, top, ACTIVE, QUIET,
                 telemetry=TelemetrySpec(), device="cpu", **kw)
    want_ch, want_pv = jax_oracles(algo, lat_name, "loss_churn")
    assert_tele_equal(got_ch, want_ch, algo)
    assert_prov_equal(got_pv, want_pv, algo)
