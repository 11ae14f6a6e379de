"""The port's operator (``easydl_tpu_torch/controller/``, ``brain/arbiter.py``,
``obs/scrape.py``) against the JAX package's, on the CPU and without pods:

- the reconcile core: the port's native core (``reconciler_core.cc``, built
  into the port's ``_build/``), its Python twin and the JAX package's
  ``reconcile_wire`` give byte-equal ops on 400 seeded random wire inputs;
- both packages' ``ElasticJobController`` over ``InMemoryPodApi`` through one
  scripted sequence (submit, the trainer first, the plan, scale up and
  down, a failed worker replaced under a fresh name, crash-loop backoff,
  replace-then-retire, a stale plan refused, a malformed replica count
  freezing its role, the terminal latch across an operator restart,
  deletion) create and delete the same pods and write the same statuses at
  every tick;
- the arbiter's decisions on seeded claims are byte-equal, each package
  replays the other's decision log, the controllers level two tenants
  alike under a ``chip_budget``, and the tenant fleets (``fleet.py``, over
  agents that drain a step after their notice) grant, preempt and drain
  alike;
- the PS split and ``serve_scale_decision`` agree on seeded inputs and on
  one workdir snapshot (the PS registry's files and live exporters'
  publications), and ``scrape.parse_text`` and ``merge_snapshot`` agree on
  the same exporters.

Each comparison also runs once with a planted fault in the port (an op
dropped from the wire, a controller that skips replace-then-retire, a
tampered decision, no chip budget, labels lost in the parse) and must
catch it.
"""

import contextlib
import json
import random
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("jax")  # parity tests hold the port to the JAX package

from easydl_tpu import api as jax_api  # noqa: E402
from easydl_tpu import controller as jax_controller  # noqa: E402
from easydl_tpu.brain import arbiter as jax_arbiter  # noqa: E402
from easydl_tpu.controller import fleet as jax_fleet  # noqa: E402
from easydl_tpu.controller import operator as jax_operator  # noqa: E402
from easydl_tpu.controller import reconciler as jax_reconciler  # noqa: E402
from easydl_tpu.obs import scrape as jax_scrape  # noqa: E402
from easydl_tpu_torch import api  # noqa: E402
from easydl_tpu_torch import controller  # noqa: E402
from easydl_tpu_torch.brain import arbiter  # noqa: E402
from easydl_tpu_torch.controller import fleet, operator, reconciler  # noqa: E402
from easydl_tpu_torch.obs import MetricsExporter, MetricsRegistry, scrape  # noqa: E402
from easydl_tpu_torch.ps import registry as ps_registry  # noqa: E402
from easydl_tpu_torch.utils import native  # noqa: E402

PORT = Path(__file__).resolve().parent.parent / "easydl_tpu_torch"
PHASES = ["Pending", "Running", "Succeeded", "Failed", "Terminating"]
ROLES = ["worker", "parameter_server", "evaluator", "trainer"]


# ------------------------------------------------------------ the core
def wire_cases(n: int, seed: int):
    """Seeded (desired, observed) wire pairs: the reference's generator
    (tests/test_controller.py) over four roles, with malformed counts,
    replacements and updations."""
    rng = random.Random(seed)
    for _ in range(n):
        names, observed = set(), []
        for _ in range(rng.randint(0, 10)):
            role = rng.choice(ROLES)
            name = f"j-{role}-{rng.randint(0, 9)}"
            if name in names:
                continue
            names.add(name)
            replaces = rng.choice(["", *sorted(names - {name})]) if rng.random() < 0.3 else ""
            observed.append(f"P|{name}|{role}|{rng.choice(PHASES)}|sig{rng.randint(0, 2)}|"
                            f"{replaces}\n")
        desired = ["J|j"]
        for role in ROLES[:3]:
            if rng.random() < 0.85:
                replicas = rng.choice([str(rng.randint(0, 6))] * 5
                                      + ["", "-1", "+2", " 3", "2x", "99999999999"])
                desired.append(f"R|{role}|{replicas}|sig{rng.randint(0, 1)}")
        for name in sorted(names)[:3]:
            if rng.random() < 0.4:
                desired.append(f"U|{name}|sig9")
        yield "\n".join(desired) + "\n", "".join(observed)


def wire_mismatches(ours) -> list:
    return [i for i, (d, o) in enumerate(wire_cases(400, 0))
            if ours(d, o) != jax_reconciler.reconcile_wire(d, o)]


def test_the_reconcile_core_its_twin_and_the_jax_core_agree():
    lib = native.load_native(reconciler._SOURCE, reconciler._bind)
    jax_lib = jax_reconciler.load_native(jax_reconciler._SOURCE, jax_reconciler._bind)
    assert Path(lib._name).parent == PORT / "_build" and lib._name != jax_lib._name
    assert Path(reconciler._SOURCE).read_bytes() == Path(jax_reconciler._SOURCE).read_bytes()
    acting = 0
    for desired, observed in wire_cases(400, 0):
        want = jax_reconciler.reconcile_wire(desired, observed)
        assert reconciler.reconcile_wire(desired, observed) == want, (desired, observed)
        assert reconciler._py_reconcile(desired, observed) == want, (desired, observed)
        acting += bool(want)
    assert acting > 250
    assert wire_mismatches(reconciler.reconcile_wire) == []

    def dropped(desired, observed):  # the planted fault: the first op lost
        return "".join(reconciler.reconcile_wire(desired, observed).splitlines(True)[1:])

    assert len(wire_mismatches(dropped)) == acting


# ------------------------------------------------------ the controller
def packages(port: bool):
    """(api, controller, StalePlanError) of the port or the JAX package."""
    if port:
        return api, controller, operator.StalePlanError
    return jax_api, jax_controller, jax_operator.StalePlanError


def run_script(port: bool) -> list:
    """One scripted sequence; a record of the pods, the pod events and the
    job's status after each step."""
    a, c, stale = packages(port)
    # the evaluator's command named: by default each package's role runs its own pod
    job = a.JobSpec(name="j", image="img:1", command="python -m trainer",
                    roles={"worker": a.RoleSpec(), "parameter_server": a.RoleSpec(),
                           "evaluator": a.RoleSpec(command="python -m evaluator")})
    store, pods = c.CrStore(), c.InMemoryPodApi()
    # the wall clock's backoff set alike in both: a second failure waits 30 s
    options = dict(restart_backoff_base=30.0, restart_backoff_max=60.0,
                   restart_backoff_reset=600.0)
    ctl = c.ElasticJobController(store, pods, **options)
    records = []

    def plan(version, workers, ps=1, updations=(), worker_cpu=8):
        return a.ResourcePlan(name="j-plan", job_name="j", version=version, roles={
            "worker": a.RolePlan(workers, a.ResourceSpec(cpu=worker_cpu, memory=8192)),
            "parameter_server": a.RolePlan(ps, a.ResourceSpec(cpu=4, memory=4096)),
            "evaluator": a.RolePlan(1, a.ResourceSpec(cpu=2))},
            resource_updation=list(updations))

    def workers():
        return sorted(p.name for p in pods.list_pods("j")
                      if p.role == "worker" and p.phase in ("Pending", "Running"))

    def record(what, result=None):
        status = dict(store.job_status("j") or {})
        if "completionTime" in status:
            status["completionTime"] = "set"  # the wall clock's second
        records.append((what, result, [
            (p.name, p.role, p.phase, p.resource.to_dict(), p.replaces, p.command, p.image)
            for p in pods.list_pods("j")], list(pods.events), status))
        pods.events.clear()

    def step(what, act=None, tick=False):
        result = act() if act is not None else None
        st = ctl.reconcile_job("j")
        record(what, (result, st.phase, st.last_ops))
        if tick:
            pods.tick()
            record(f"{what}: tick")

    store.submit_job(job)
    step("submit: the trainer pod alone", tick=True)
    step("plan v1", lambda: store.apply_plan(plan(1, 2)), tick=True)
    step("scale up", lambda: store.apply_plan(plan(2, 4)), tick=True)
    step("scale down", lambda: store.apply_plan(plan(3, 2)), tick=True)
    step("a malformed count", lambda: store.apply_plan(plan(4, 12_345_678)), tick=True)
    step("one worker", lambda: store.apply_plan(plan(5, 1)), tick=True)
    step("a failed worker", lambda: pods.fail(workers()[0]), tick=True)
    step("a second failure: backoff", lambda: pods.fail(workers()[0]))
    step("still deferred")
    upd = a.ResourceUpdation("j-parameter_server-0", a.ResourceSpec(cpu=16, memory=16384))
    step("replace-then-retire", lambda: store.apply_plan(plan(6, 1, updations=[upd])))
    step("the replacement pending")
    step("the replacement running", pods.tick)
    step("retired", pods.tick)

    def refused():
        try:
            store.apply_plan(plan(6, 3))
        except stale as e:
            return f"refused: {e}"

    step("a stale plan", refused)
    step("a drifted role resource", lambda: store.apply_plan(plan(7, 1, worker_cpu=2)),
         tick=True)

    def finish():
        for p in pods.list_pods("j"):
            if p.role in ("worker", "trainer"):
                pods.set_phase(p.name, "Succeeded")

    step("the trainer done: latched", finish)
    step("a plan after the end", lambda: store.apply_plan(plan(8, 3)))
    ctl = c.ElasticJobController(store, pods, **options)  # the operator restarts
    step("latched after a restart")
    store2, pods2 = c.CrStore(), c.InMemoryPodApi()  # a restart that kept only the CR
    store2.submit_job(job)
    store2.set_status("j", store.job_status("j"))
    st = c.ElasticJobController(store2, pods2, **options).reconcile_job("j")
    records.append(("latched from the status alone", st.phase, pods2.list_pods("j")))
    step("deleted", lambda: store.delete_job("j"))
    return records


def skip_replace_then_retire(job_name, plan, observed, force_python=False):
    """The planted fault: the plan's resource_updation never reaches the core."""
    bare = api.ResourcePlan(name=plan.name, job_name=plan.job_name, roles=plan.roles,
                            version=plan.version)
    return reconciler.reconcile(job_name, bare, observed, force_python=force_python)


def test_the_controllers_run_one_script_alike():
    ours, theirs = run_script(port=True), run_script(port=False)
    assert len(ours) == len(theirs) == 28
    for a, b in zip(ours, theirs):
        assert a == b, a[0]
    at = {r[0]: r for r in ours}
    assert [p[0] for p in at["submit: the trainer pod alone"][2]] == ["j-trainer-0"]
    assert "refused: stale plan version 6 <= 6" in at["a stale plan"][1]
    assert at["a malformed count"][1][2] == [] and len(
        [p for p in at["a malformed count"][2] if p[1] == "worker"]) == 2  # frozen
    assert at["a failed worker"][1][2] == ["DELETE j-worker-0 (failed)", "CREATE j-worker-1"]
    assert at["a second failure: backoff"][1][2] == ["DELETE j-worker-1 (failed)"]
    assert at["still deferred"][1][2] == []
    assert at["latched after a restart"][1][1] == "Succeeded"
    assert at["latched from the status alone"][1:] == ("Succeeded", [])
    assert at["deleted"][2] == []
    with mock.patch.object(operator, "reconcile", skip_replace_then_retire):
        faulty = run_script(port=True)
    differ = [a[0] for a, b in zip(faulty, theirs) if a != b]
    assert differ and differ[0] == "replace-then-retire", differ


# ------------------------------------------------------ the arbiter
def claims(rng, n_jobs: int, pkg):
    out = []
    for i in range(n_jobs):
        lo = rng.randint(0, 3)
        out.append(pkg.JobClaim(name=f"job{i}", priority=rng.randint(-1, 3), min_chips=lo,
                                max_chips=lo + rng.randint(0, 5), demand=rng.randint(0, 9),
                                allocated=rng.randint(0, 6)))
    return out


def arbitrate(pkg, seed: int):
    """A seeded run of GlobalChipArbiter over a virtual clock: the decisions'
    bytes, the pure water-fill's targets and the arbiter's log."""
    rng = random.Random(seed)
    arb = pkg.GlobalChipArbiter(pkg.ArbiterConfig(holddown_s=rng.choice([0.0, 2.5, 10.0]),
                                                  max_preemptions_per_decision=rng.randint(1, 3)))
    out = []
    for t in range(40):
        cl = claims(rng, rng.randint(1, 5), pkg)
        total = rng.randint(0, 16)
        out.append((pkg.decision_bytes(arb.decide(cl, total, now=t * 0.7 + 0.1234567)),
                    pkg.target_allocations(cl, total)))
    return out, arb.log


def test_the_arbiter_decides_and_replays_as_the_jax_packages():
    for seed in range(10):
        (ours, our_log), (theirs, their_log) = arbitrate(arbiter, seed), arbitrate(jax_arbiter,
                                                                                 seed)
        assert ours == theirs
        assert arbiter.replay_decision_log(their_log)["identical"]
        assert jax_arbiter.replay_decision_log(our_log)["identical"]
    tampered = json.loads(json.dumps(their_log))  # the planted fault: one verdict changed
    verdict = tampered[17]["verdict"]["allocations"]
    verdict[next(iter(verdict))] += 1
    got = arbiter.replay_decision_log(tampered)
    assert not got["identical"] and [m["index"] for m in got["mismatches"]] == [17]


def run_tenants(port: bool, budget=4) -> list:
    a, c, _ = packages(port)
    arb = arbiter if port else jax_arbiter
    store, pods = c.CrStore(), c.InMemoryPodApi()
    ctl = c.ElasticJobController(store, pods, chip_budget=budget, arbiter_config=arb.ArbiterConfig(
        holddown_s=0.0, max_preemptions_per_decision=4))
    for name, priority, lo, hi in (("hi", 2, 1, 4), ("lo", 0, 1, 3)):
        store.submit_job(a.JobSpec(name=name, image="img", command="python -m trainer",
                                   roles={"worker": a.RoleSpec()},
                                   scheduling=a.job_spec.SchedulingSpec(
                                       priority=priority, min_replicas=lo, max_replicas=hi)))
    out = []
    for plans in ({"hi": (1, 1), "lo": (3, 1)}, {"hi": (4, 2)}, {"lo": (1, 2)}):
        for name, (workers, version) in plans.items():
            store.apply_plan(a.ResourcePlan(name=f"{name}-plan", job_name=name,
                                            version=version, roles={"worker": a.RolePlan(
                                                workers, a.ResourceSpec(cpu=1))}))
        for _ in range(4):
            ctl.reconcile_all()
            pods.tick()
        out.append({j: sorted((p.name, p.phase) for p in pods.list_pods(j)) for j in ("hi", "lo")})
    return out


def test_the_tenant_path_levels_jobs_alike_under_a_chip_budget():
    ours = run_tenants(port=True)
    assert ours == run_tenants(port=False)
    live = [{j: sum(p[0].split("-")[1] == "worker" for p in v) for j, v in r.items()}
            for r in ours]
    assert live == [{"hi": 1, "lo": 3}, {"hi": 3, "lo": 1}, {"hi": 3, "lo": 1}]
    assert run_tenants(port=True, budget=None) != ours  # the planted fault: no budget


class FakeMaster:
    def __init__(self):
        self.members = []

    def status(self):
        return {"members": list(self.members)}


class FakeAgent:
    """Drains (its worker exits, the master drops it) one tick after its
    preemption notice, as tests/test_tenant_fleet.py's agent does."""

    def __init__(self, aid, master):
        self.aid, self.master, self.noticed, self.worker_pid = aid, master, False, 1234
        master.members = master.members or [aid]

    def notify_preemption(self):
        self.noticed = True

    def tick(self):
        if self.noticed and self.worker_pid is not None:
            self.worker_pid = None
            self.master.members = [m for m in self.master.members if m != self.aid]

    def stop(self):
        assert self.worker_pid is None, "stopped before its drain"


def run_fleet(pkg, arb, seed: int):
    rng, agents = random.Random(seed), []

    def factory(aid, master, job):
        agents.append(FakeAgent(aid, master))
        return agents[-1]

    f = pkg.TenantFleet(6, factory, arb.ArbiterConfig(holddown_s=1.0,
                                                      max_preemptions_per_decision=2),
                        drain_timeout_s=100.0, epoch=0.0)
    for i in range(3):
        lo = rng.randint(0, 2)
        f.add_job(pkg.TenantJob(name=f"job{i}", master=FakeMaster(), workdir=".",
                                priority=rng.randint(0, 3), min_chips=lo,
                                max_chips=lo + rng.randint(1, 4), demand=rng.randint(0, 5)))
    for t in range(24):
        if t % 5 == 4:
            f.set_demand(f"job{rng.randint(0, 2)}", rng.randint(0, 6))
        f.tick(now=t * 0.5)
        for a in list(agents):
            a.tick()
    ev = f.evidence()
    for j in ev["profile"]["jobs"]:  # set_demand stamps the wall clock
        j["demand"] = [d for _, d in j["demand"]]
    return ev


def test_the_tenant_fleets_grant_preempt_and_drain_alike():
    preempted = 0
    for seed in range(6):
        ours = run_fleet(fleet, arbiter, seed)
        assert ours == run_fleet(jax_fleet, jax_arbiter, seed)
        assert jax_arbiter.replay_decision_log(ours["decision_log"])["identical"]
        preempted += len(ours["preempt_drains"])
    assert preempted > 0
    with mock.patch.object(fleet.TenantFleet, "_victim_agent", lambda self, job: None):
        faulty = run_fleet(fleet, arbiter, 0)  # the planted fault: no victim found
    assert faulty != run_fleet(jax_fleet, jax_arbiter, 0)


# ------------------------------------------ the PS split, serving and scrape
def decision_inputs(rng):
    shards = rng.randint(1, 6)
    rows = {s: float(rng.randint(0, 80_000)) for s in range(shards)}
    access = {s: float(rng.randint(0, 1_000)) for s in range(shards)} if rng.random() < 0.5 \
        else None
    qps = {f"r{i}": rng.uniform(0, 900) for i in range(rng.randint(0, 5))}
    p99 = {k: rng.uniform(0, 0.12) for k in qps}
    router = ({"router_offered_qps": rng.uniform(0, 3000), "router_replicas": rng.randint(0, 6),
               "router_p99_s": rng.uniform(0, 0.1)} if rng.random() < 0.4 else {})
    return (rows, shards, access), (qps, p99, router)


def test_the_split_and_scale_decisions_are_the_jax_packages():
    rng, verdicts = random.Random(3), set()
    for _ in range(300):
        (rows, shards, access), (qps, p99, router) = decision_inputs(rng)
        kw = dict(min_total_rows=rng.choice([0, 50_000, 200_000]), shard_access=access)
        got = reconciler.ps_split_decision(rows, shards, **kw)
        assert got == jax_reconciler.ps_split_decision(rows, shards, **kw)
        serve = reconciler.serve_scale_decision(qps, p99, **router)
        assert serve == jax_reconciler.serve_scale_decision(qps, p99, **router)
        verdicts.update({("split", got), ("serve", serve)})
    assert len(verdicts) > 8  # both verdicts took many values


@contextlib.contextmanager
def snapshot_workdir(tmp_path):
    """A workdir with two committed PS pods and a superseded one in the
    registry, each exporting its rows and pulls, and two serving replicas
    and a router exporting their rolling gauges; the exporters serve the
    port's and the JAX package's registries (their text is one format)."""
    from easydl_tpu.obs import MetricsExporter as JaxExporter
    from easydl_tpu.obs import MetricsRegistry as JaxRegistry

    work = str(tmp_path)
    exporters = []

    def export(component, registry_cls, exporter_cls, series):
        reg = registry_cls()
        for kind, name, value, labels in series:
            metric = (reg.gauge if kind == "gauge" else reg.counter)(name, name, tuple(labels))
            (metric.set if kind == "gauge" else metric.inc)(value, **labels)
        exporters.append(exporter_cls(registry=reg, component=component, workdir=work))

    for pod, shard, rows, pulls in (("p0", 0, 900_000, 5_000), ("p1", 1, 100_000, 40_000)):
        ps_registry.publish(work, pod, shard, 2, "localhost:1")
        export(f"ps-{pod}", MetricsRegistry, MetricsExporter, [
            ("gauge", "easydl_ps_table_rows", rows, {"table": "emb", "shard": str(shard)}),
            ("counter", "easydl_ps_pull_ids_total", pulls, {"shard": str(shard)})])
    # a superseded source, alive and exporting, not in the registry
    export("ps-old", MetricsRegistry, MetricsExporter, [
        ("gauge", "easydl_ps_table_rows", 5_000_000, {"table": "emb", "shard": "1"})])
    for replica, qps, p99 in (("r0", 700.0, 0.020), ("r1", 640.0, 0.030)):
        export(f"serve-{replica}", JaxRegistry, JaxExporter, [
            ("gauge", "easydl_serve_qps_recent", qps, {"replica": replica}),
            ("gauge", "easydl_serve_p99_seconds_recent", p99, {"replica": replica}),
            ("counter", "easydl_rpc_server_requests_total", 10, {"method": "Infer"})])
    export("router", JaxRegistry, JaxExporter, [
        ("gauge", "easydl_serve_router_offered_qps_recent", 1500.0, {"replica": "router"}),
        ("gauge", "easydl_serve_router_live_replicas", 2, {"replica": "router"}),
        ("gauge", "easydl_serve_router_p99_seconds_recent", 0.04, {"replica": "router"})])
    try:
        yield work
    finally:
        for e in exporters:
            e.stop()


def verdicts(pkg, work):
    return ([pkg.maybe_split_ps(work, hot_ratio=r, min_total_rows=m)
             for r in (1.5, 1.9) for m in (10_000, 2_000_000)],
            [pkg.maybe_scale_serve(work, target_qps=q, p99_budget_s=b)
             for q in (400.0, 900.0, 2000.0) for b in (0.01, 0.05)])


def labels_lost(text):  # the planted fault: the parse drops every label set
    return {k.split("{")[0]: v for k, v in jax_scrape.parse_text(text).items()}


def test_the_operator_reads_one_workdir_snapshot_as_the_jax_package(tmp_path):
    with snapshot_workdir(tmp_path) as work:
        ours = verdicts(reconciler, work)
        assert ours == verdicts(jax_reconciler, work)
        assert ours == ([4, None, None, None], [4, 4, 3, None, 3, None])
        with mock.patch.object(scrape, "parse_text", labels_lost):
            assert verdicts(reconciler, work) == ([None] * 4, [None] * 6)


def exposition(rng) -> str:
    lines = []
    for i in range(rng.randint(1, 12)):
        labels = {k: rng.choice(["a", "b b", 'q"x', "c\\\\d"])
                  for k in rng.sample(["shard", "table", "replica", "method"], rng.randint(0, 3))}
        text = ",".join(f'{k}="{v}"' for k, v in labels.items())
        value = rng.choice([str(rng.randint(0, 10**6)), f"{rng.uniform(-5, 5):.6g}", "NaN",
                            "+Inf", "junk"])
        lines.append(rng.choice(["", "# HELP x y", "# TYPE x gauge"]))
        lines.append(f"easydl_m{i % 4}_{rng.choice(['total', 'seconds', 'bucket'])}"
                     f"{'{' + text + '}' if text else ''} {value}")
    return "\n".join(lines)


def test_scrape_parses_and_merges_as_the_jax_package(tmp_path):
    rng = random.Random(5)
    for _ in range(200):
        text = exposition(rng)
        got = scrape.parse_text(text)
        assert json.dumps(got, sort_keys=True) == json.dumps(jax_scrape.parse_text(text),
                                                             sort_keys=True)
    with snapshot_workdir(tmp_path) as work:
        assert scrape.discover(work) == jax_scrape.discover(work)
        ours, theirs = scrape.merge_snapshot(work), jax_scrape.merge_snapshot(work)
        assert ours["merged"] == theirs["merged"] and len(ours["merged"]) == 12
        assert {c: d["metrics"] for c, d in ours["services"].items()} == {
            c: d["metrics"] for c, d in theirs["services"].items()}
        # the two replicas' request counters, one series in two processes' registries, summed
        assert ours["merged"]['easydl_rpc_server_requests_total{method="Infer"}'] == 20
        with mock.patch.object(scrape, "parse_text", labels_lost):
            assert scrape.merge_snapshot(work)["merged"] != theirs["merged"]
