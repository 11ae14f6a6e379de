"""The port's serve fleet layer against the JAX package's:

- **pure functions**: ``route_decision``, ``hedge_decision``,
  ``hedge_delay_s``, ``probe_due``, ``session_weight`` (``serve/routing``),
  ``assign_arm`` and ``rollout_decision`` with ``RolloutPacer``
  (``loop/rollout``) give the reference's answers on seeded random inputs;
- **mixed fleets**: the port's ``ServeRouter`` in front of a JAX replica,
  and the JAX router in front of a port replica, over gRPC: the routed
  scores equal a direct ``infer`` on the replica, bit for bit (the numpy
  scorer) and for DeepFM's tower; a router over one replica of each
  package routes every request to one or the other with the same scores;
- **the entry point**: ``python -m easydl_tpu_torch.serve --deepfm
  --device cpu``, started by the port's ``spawn_replicas`` on two of the
  port's PS pods, is discovered by the port's router, scores as the
  same-seed forward built here, and on SIGTERM exits 0 and removes its
  discovery file. Without ``--device cpu`` it refuses to run without a
  card (``tests/test_torch_port_rules.py``).
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import easydl_tpu.loop.rollout as jax_rollout  # noqa: E402
import easydl_tpu.ps.client as jax_client  # noqa: E402
import easydl_tpu.ps.read_client as jax_read_client  # noqa: E402
import easydl_tpu.ps.table as jax_table  # noqa: E402
import easydl_tpu.serve as jax_serve  # noqa: E402
import easydl_tpu.serve.frontend as jax_frontend  # noqa: E402
import easydl_tpu.serve.routing as jax_routing  # noqa: E402
import easydl_tpu_torch.loop.rollout as pt_rollout  # noqa: E402
import easydl_tpu_torch.ps.client as pt_client  # noqa: E402
import easydl_tpu_torch.ps.read_client as pt_read_client  # noqa: E402
import easydl_tpu_torch.ps.table as pt_table  # noqa: E402
import easydl_tpu_torch.serve as pt_serve  # noqa: E402
import easydl_tpu_torch.serve.frontend as pt_frontend  # noqa: E402
import easydl_tpu_torch.serve.routing as pt_routing  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIELDS, DIM, DENSE, HIDDEN = 4, 8, 3, (16,)
#: f32 end to end, as tests/test_torch_serve.py's SCORER_REL
SCORER_REL = 1e-5

PACKAGES = {
    "jax": (jax_client, jax_read_client, jax_table, jax_serve, jax_frontend),
    "port": (pt_client, pt_read_client, pt_table, pt_serve, pt_frontend),
}


# ---------------------------------------------------------- pure functions
def views(mod, rng, n: int) -> list:
    return [mod.ReplicaView(name=f"r{i}", outstanding=int(rng.integers(0, 4)),
                            qps_recent=float(rng.choice([0.0, 10.0, 20.0])),
                            p99_recent_s=float(rng.choice([0.0, 0.01, 0.05])),
                            healthy=bool(rng.random() > 0.2)) for i in range(n)]


def test_routing_decisions_match_the_reference():
    rng_j, rng_p = np.random.default_rng(11), np.random.default_rng(11)
    decided = set()
    for trial in range(300):
        n = 1 + trial % 5
        vj, vp = views(jax_routing, rng_j, n), views(pt_routing, rng_p, n)
        session = f"s{trial}" if trial % 3 else ""
        exclude = tuple(f"r{i}" for i in range(n) if (trial >> i) & 1 and i % 2)
        salt = "" if trial % 4 else "salt"
        got = pt_routing.route_decision(vp, session, exclude, salt)
        assert got == jax_routing.route_decision(vj, session, exclude, salt)
        primary = got or "r0"
        args = (primary, trial % 7, 1 + trial % 13, (trial % 5) / 10.0)
        hedge = pt_routing.hedge_decision(vp, *args, session_id=session)
        assert hedge == jax_routing.hedge_decision(vj, *args, session_id=session)
        decided.update({got, hedge})
        assert pt_routing.session_weight(session, primary, salt) == \
            jax_routing.session_weight(session, primary, salt)
        p95, lo, hi = rng_j.random() * 0.3, 0.005 * (trial % 3), 0.2
        rng_p.random()
        assert pt_routing.hedge_delay_s(p95, lo, hi) == jax_routing.hedge_delay_s(p95, lo, hi)
        now, at = trial * 0.25, (trial % 11) * 0.5
        assert pt_routing.probe_due(now, at, 2.0) == jax_routing.probe_due(now, at, 2.0)
    assert None in decided and len(decided) > 3


def test_rollout_arms_and_pacing_match_the_reference():
    rng = np.random.default_rng(3)
    arms = []
    for i in range(2000):
        fraction = float(rng.choice([-0.1, 0.0, 0.05, 0.3, 0.5, 1.0, 1.2]))
        session, salt = f"user-{rng.integers(0, 10**9)}", ("", "v7")[i % 2]
        arm = pt_rollout.assign_arm(session, fraction, salt)
        assert arm == jax_rollout.assign_arm(session, fraction, salt)
        arms.append(arm)
    assert {pt_rollout.CANARY, pt_rollout.CONTROL} <= set(arms)
    config = {"min_observations": 20, "min_soak_s": 5.0, "min_control_observations": 10}
    pacers = {"jax": jax_rollout.RolloutPacer(jax_rollout.RolloutPacingConfig(**config)),
              "port": pt_rollout.RolloutPacer(pt_rollout.RolloutPacingConfig(**config))}
    decisions = set()
    for step in range(400):
        if step % 100 == 0:
            for p in pacers.values():
                p.start_canary(step // 100 + 1, step * 0.1)
        arm = ("canary", "control")[int(rng.integers(0, 2))]
        ok = bool(rng.random() > (0.3 if step >= 300 else 0.01))
        for p in pacers.values():
            p.observe(arm, ok)
        got = pacers["port"].decide(step * 0.1)
        assert got == pacers["jax"].decide(step * 0.1)
        decisions.add(got["decision"])
    assert decisions == {"hold", "promote", "rollback"}


# ------------------------------------------------------------ mixed fleets
def jax_params() -> dict:
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from easydl_tpu.models.deepfm import DeepFMDense

    params = DeepFMDense(hidden=HIDDEN).init(
        jax.random.PRNGKey(2), jnp.zeros((1, FIELDS, DIM)), jnp.zeros((1, DENSE)))["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def replica(pkg: str, name: str, forward):
    client, read_client, table, serve, _ = PACKAGES[pkg]
    ps = client.LocalPsClient(num_shards=2)
    ps.create_table(table.TableSpec(name="emb", dim=DIM, optimizer="sgd", lr=0.1, seed=3))
    fe = serve.ServeFrontend(read_client.PsReadClient(ps, cache=serve.HotIdCache(1 << 20)),
                             serve.ServeConfig(table="emb", fields=FIELDS, dense_dim=DENSE,
                                               max_wait_ms=1.0),
                             forward=forward, name=name)
    return fe, fe.serve()


def forward_of(pkg: str, scorer: str, params):
    frontend = PACKAGES[pkg][4]
    if scorer == "numpy":
        return frontend._numpy_forward
    options = {"device": "cpu"} if pkg == "port" else {}
    return frontend.make_deepfm_forward(FIELDS, DIM, DENSE, hidden=HIDDEN, params=params,
                                        **options)


def traffic(n: int) -> list:
    rng = np.random.default_rng(4)
    return [(rng.integers(0, 5000, (1 + i % 4, FIELDS), dtype=np.int64),
             rng.standard_normal((1 + i % 4, DENSE)).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("scorer", ["numpy", "deepfm"])
@pytest.mark.parametrize("router_pkg,replica_pkg", [("port", "jax"), ("jax", "port")])
def test_a_router_serves_the_other_packages_replica(router_pkg, replica_pkg, scorer):
    params = jax_params() if scorer == "deepfm" else None
    forward = forward_of(replica_pkg, scorer, params)
    fe, server = replica(replica_pkg, "r0", forward)
    router = PACKAGES[router_pkg][3].ServeRouter(addresses={"r0": server.address},
                                                 timeout_s=30.0, hedge_budget=0.0)
    reference = forward if replica_pkg == "jax" else forward_of("jax", scorer, params)
    try:
        for ids, dense in traffic(6):
            routed, direct = router.infer(ids, dense), fe.infer(ids, dense)
            assert routed.ok and direct.ok, (routed.verdict, direct.verdict)
            np.testing.assert_array_equal(routed.scores, direct.scores)
            want = np.asarray(reference(fe.reads.client.pull("emb", ids), dense))
            if scorer == "numpy":
                np.testing.assert_array_equal(routed.scores, want)
            else:
                assert np.linalg.norm(routed.scores - want) <= SCORER_REL * np.linalg.norm(want)
        assert router.counters["ok"] == 6 and router.counters["error"] == 0
    finally:
        router.stop()
        fe.stop()


def test_a_router_over_both_packages_replicas():
    params = jax_params()
    fleet = {pkg: replica(pkg, f"r-{pkg}", forward_of(pkg, "deepfm", params))
             for pkg in PACKAGES}
    router = pt_serve.ServeRouter(addresses={fe.name: sv.address for fe, sv in fleet.values()},
                                  timeout_s=30.0, hedge_budget=0.0)
    try:
        reqs = traffic(12)
        routed = [router.infer(ids, dense, session_id=f"s{i}") for i, (ids, dense) in
                  enumerate(reqs)]
        served = {pkg: fe.batches_run for pkg, (fe, _) in fleet.items()}
        assert all(served.values()), served  # the sessions spread over both
        for got, (ids, dense) in zip(routed, reqs):
            assert got.ok, got.verdict
            for fe, _ in fleet.values():
                want = fe.infer(ids, dense).scores
                assert np.linalg.norm(got.scores - want) <= SCORER_REL * np.linalg.norm(want)
    finally:
        router.stop()
        for fe, _ in fleet.values():
            fe.stop()


# ------------------------------------------------------------- entry point
def test_the_replica_process_serves_on_the_cpu_and_stops_on_sigterm(tmp_path):
    from easydl_tpu_torch.ps import registry
    from easydl_tpu_torch.serve.launch import spawn_replicas

    work = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    pods = [subprocess.Popen([sys.executable, "-m", "easydl_tpu_torch.ps", "--name", f"ps-{i}",
                              "--workdir", work, "--num-shards", "2", "--shard-index", str(i)],
                             cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.STDOUT) for i in range(2)]
    procs = {}
    try:
        registry.discover(work, timeout=60)
        writer = pt_client.ShardedPsClient.from_registry(work, 2, wait_s=30)
        writer.create_table(pt_table.TableSpec(name="emb", dim=DIM))
        log = str(tmp_path / "replica.log")
        procs = spawn_replicas(1, work, "emb", FIELDS, wait_s=120, log_path=log,
                               extra_args=["--deepfm", "--device", "cpu", "--dim", str(DIM),
                                           "--dense-dim", str(DENSE), "--hidden", "16"],
                               extra_env={"OMP_NUM_THREADS": "1"})
        router = pt_serve.ServeRouter(workdir=work, timeout_s=30.0, hedge_budget=0.0)
        same_seed = pt_frontend.make_deepfm_forward(FIELDS, DIM, DENSE, hidden=HIDDEN,
                                                    device="cpu")
        try:
            for ids, dense in traffic(3):
                got = router.infer(ids, dense)
                assert got.ok, got.verdict
                want = same_seed(writer.pull("emb", ids), dense)
                assert got.scores.shape == (len(ids),)
                assert np.linalg.norm(got.scores - want) <= SCORER_REL * np.linalg.norm(want)
            assert list(router.replicas()) == ["serve-0"]
        finally:
            router.stop()
            writer.close()
        proc = procs["serve-0"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, open(log).read()[-2000:]
        assert not os.path.exists(os.path.join(work, "serve", "serve-0.json"))
    finally:
        for p in [*procs.values(), *pods]:
            if p.poll() is None:
                p.kill()
                p.wait()
