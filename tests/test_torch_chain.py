"""The port's `plane.chain_windows` against the JAX package's, bitwise:
consecutive chains over the (rr, aqm, no_loss) matrix of
`tests/test_chain_driver.py`, with the metrics and guard planes and the
AQM, with a traffic generator (`workload=`), with the flow and compute
planes, and through the fused kernel pair (JAX in interpret mode). Each chain's state, delivered
dict, offset, next event and window count are compared, and the next
chain opens at the previous one's next event."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, assert_tuples_equal,  # noqa: E402
                          jax_params_to_numpy, jax_state_to_numpy)

from shadow_tpu.guards import make_guards  # noqa: E402
from shadow_tpu.telemetry import make_metrics  # noqa: E402
from shadow_tpu.tpu import profiling  # noqa: E402
from shadow_tpu.tpu.plane import chain_windows  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.guards import plane as tguards  # noqa: E402
from shadow_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

I32_MAX = 2**31 - 1
N = 32
W = 1_000_000  # window and run-ahead: most windows deliver nothing
HORIZON = 200_000_000
CHAINS = 6


def worlds(egress_cap=8, ingress_cap=16):
    """`tests/test_chain_driver.py`'s world (the bench world at N=32, M=8,
    seed 3, one warm-up window) in both packages."""
    w = profiling.build_world(N, n_nodes=8, egress_cap=egress_cap,
                              ingress_cap=ingress_cap, seed=3,
                              warmup_windows=1)
    tst = convert.state_from_numpy(jax_state_to_numpy(w["state"]), "cpu")
    tparams = convert.params_from_numpy(jax_params_to_numpy(w["params"]),
                                        "cpu")
    return w, tst, tparams


def assert_chain_equal(jout, tout, ctx, planes=()):
    """(state, delivered, off, next_rel, n_windows[, planes...])."""
    assert len(jout) == len(tout), ctx
    assert_states_equal(jax_state_to_numpy(jout[0]),
                        convert.state_to_numpy(tout[0]), ctx)
    assert jout[1].keys() == tout[1].keys()
    for k in jout[1]:
        assert np.array_equal(np.asarray(jout[1][k]), tout[1][k].numpy()), \
            (ctx, k)
    for i in (2, 3, 4):
        assert tout[i].dtype == torch.int32 and tout[i].dim() == 0
        assert int(jout[i]) == int(tout[i]), (ctx, i)
    for i, _name in enumerate(planes):
        assert_tuples_equal(jout[5 + i], tout[5 + i], (ctx, _name))


def run_chains(jfn, tfn, jst, tst, jplanes=(), tplanes=(), chains=CHAINS):
    """Consecutive chains from one state: chain c + 1 opens at chain c's
    next event. Returns the windows each chain advanced."""
    shift, lengths, r0 = 0, [], 0
    for c in range(chains):
        jout = jfn(jst, jnp.int32(shift), jnp.int32(r0), *jplanes)
        tout = tfn(tst, shift, r0, *tplanes)
        assert_chain_equal(jout, tout, c, planes=jplanes)
        jst, tst = jout[0], tout[0]
        jplanes, tplanes = jout[5:], tout[5:]
        lengths.append(int(tout[4]))
        r0 += int(tout[4])
        if int(tout[3]) >= I32_MAX // 2:
            break
        shift = int(tout[3])
    return lengths


@pytest.mark.parametrize("rr,aqm,no_loss",
                         [(False, False, False), (True, False, False),
                          (False, True, False), (True, True, True)])
def test_chain_windows_matches_jax(rr, aqm, no_loss):
    w, tst, tparams = worlds()
    kw = dict(rr_enabled=rr, router_aqm=aqm, no_loss=no_loss)
    jfn = jax.jit(lambda st, sh, _r: chain_windows(
        st, w["params"], w["rng_root"], sh, W, W, HORIZON, HORIZON, **kw))
    tfn = lambda st, sh, _r: tplane.chain_windows(
        st, tparams, 1, sh, W, W, HORIZON, HORIZON, **kw)
    before = dict(pipeline.LAUNCHES)
    lengths = run_chains(jfn, tfn, w["state"], tst)
    assert pipeline.LAUNCHES == before
    assert max(lengths) > 1, "no chain advanced past its first window"


def test_chain_windows_threads_metrics_and_guards_under_the_aqm():
    w, tst, tparams = worlds()
    kw = dict(rr_enabled=False, router_aqm=True)
    jfn = jax.jit(lambda st, sh, _r, m, g: chain_windows(
        st, w["params"], w["rng_root"], sh, W, W, HORIZON, HORIZON,
        metrics=m, guards=g, **kw))
    tfn = lambda st, sh, _r, m, g: tplane.chain_windows(
        st, tparams, 1, sh, W, W, HORIZON, HORIZON, metrics=m, guards=g,
        **kw)
    lengths = run_chains(
        jfn, tfn, w["state"], tst, (make_metrics(N), make_guards(N)),
        (tmetrics.make_metrics(N, device="cpu"),
         tguards.make_guards(N, device="cpu")))
    assert max(lengths) > 1


def test_chain_windows_with_a_workload_matches_jax():
    """The mixed scenario's generator after each chained window (its
    emission re-arms the next event), `round0` stamping its phases."""
    from pathlib import Path

    from shadow_tpu.workloads import compile as jcompile
    from shadow_tpu.workloads import device as jdevice
    from shadow_tpu.workloads import runner as jrunner
    from shadow_tpu.workloads import spec as jspec
    from shadow_tpu_torch.workloads import compile as tcompile
    from shadow_tpu_torch.workloads import device as tdevice
    from shadow_tpu_torch.workloads import runner as trunner
    from shadow_tpu_torch.workloads import spec as tspec

    path = str(Path(__file__).resolve().parent.parent / "scenarios"
               / "mixed.yaml")
    spec = jspec.load_scenario_file(path)
    prog = jcompile.compile_program(spec)
    jst, params = jrunner.build_scenario_world(spec)
    wl, ws = jdevice.to_device(prog), jdevice.make_workload_state(prog)
    jst, ws = jdevice.prime(wl, ws, jst)
    tsp = tspec.load_scenario_file(path)
    tprog = tcompile.compile_program(tsp)
    tst, tparams = trunner.build_scenario_world(tsp, device="cpu")
    twl = tdevice.to_device(tprog, "cpu")
    tws = tdevice.make_workload_state(tprog, "cpu")
    tst, tws = tdevice.prime(twl, tws, tst)
    key, win = jax.random.key(spec.seed), spec.window_ns
    stop = 60 * win

    jfn = jax.jit(lambda st, sh, r0, ws: chain_windows(
        st, params, key, sh, win, win, stop, stop, rr_enabled=False,
        workload=(wl, ws), round0=r0))
    tfn = lambda st, sh, r0, ws: tplane.chain_windows(
        st, tparams, spec.seed, sh, win, win, stop, stop, rr_enabled=False,
        workload=(twl, ws), round0=r0)
    lengths = run_chains(jfn, tfn, jst, tst, (ws,), (tws,), chains=8)
    assert sum(lengths) > len(lengths), "every chain ran one window"
    with pytest.raises(ValueError, match="not both"):
        tplane.chain_windows(tst, tparams, 0, 0, win, win, stop, stop,
                             workload=(twl, tws), flows=(None, None))


def test_chain_windows_fused_kernel_matches_jax():
    """kernel="pallas_fused" with the AQM (JAX's Pallas pair in
    interpret mode, the port's plain versions of A, B and E)."""
    w, tst, tparams = worlds()
    kw = dict(rr_enabled=False, router_aqm=True, kernel="pallas_fused")
    jfn = jax.jit(lambda st, sh, _r: chain_windows(
        st, w["params"], w["rng_root"], sh, W, W, HORIZON, HORIZON, **kw))
    tfn = lambda st, sh, _r: tplane.chain_windows(
        st, tparams, 1, sh, W, W, HORIZON, HORIZON, **kw)
    lengths = run_chains(jfn, tfn, w["state"], tst, chains=4)
    assert max(lengths) > 1


def test_chain_windows_with_flows_and_compute_matches_jax():
    """The serving entry's world primed onto its flows, chained with the
    flow plane (its emission and RTO deadlines re-arm the next event),
    the compute plane and metrics, under the router AQM (the flow and
    compute planes read the [N, CI + 1] delivered dict)."""
    from test_torch_flows import WINDOW, serve_world

    from shadow_tpu.tpu import compute as jcompute
    from shadow_tpu.tpu import flows as jflows
    from shadow_tpu_torch.tpu import compute as tcompute
    from shadow_tpu_torch.tpu import flows as tflows

    (jsp, jprog, jst, params, jft, jct), (_tp, tst, tparams, tft, tct) = \
        serve_world()
    n, f = jsp.n_hosts, jprog.flow_src.shape[0]
    ids = np.asarray(jprog.lane_flow).reshape(n, -1)
    valid = ids >= 0
    jfs = jflows.enqueue(jft, jflows.make_flow_state(f), jnp.asarray(ids),
                         jnp.asarray(valid))
    tfs = tflows.enqueue(tft, tflows.make_flow_state(f, device="cpu"),
                         torch.from_numpy(ids), torch.from_numpy(valid))
    key = jax.random.key(jsp.seed)
    stop = 200 * WINDOW
    kw = dict(rr_enabled=False, router_aqm=True)
    jfn = jax.jit(lambda st, sh, _r, m, fs, cs: chain_windows(
        st, params, key, sh, WINDOW, WINDOW, stop, stop, metrics=m,
        flows=(jft, fs), compute=(jct, cs), **kw))
    tfn = lambda st, sh, _r, m, fs, cs: tplane.chain_windows(
        st, tparams, jsp.seed, sh, WINDOW, WINDOW, stop, stop, metrics=m,
        flows=(tft, fs), compute=(tct, cs), **kw)
    lengths = run_chains(
        jfn, tfn, jst, tst,
        (make_metrics(n), jfs, jcompute.make_compute_state(jct)),
        (tmetrics.make_metrics(n, device="cpu"), tfs,
         tcompute.make_compute_state(tct)), chains=10)
    assert max(lengths) > 1, "no chain advanced past its first window"
