"""The reference's whole lifecycle through the port's operator, every pod a
process on this host:

    ElasticJob -> operator -> trainer pod -> Brain -> JobResource -> worker
    and evaluator pods -> the worker pod SIGKILLed and replaced by the
    operator -> the job Succeeded

as ``tests/test_full_lifecycle.py`` drives the JAX package's: the port's
``CrStore`` and ``ElasticJobController`` over ``LocalProcessPodApi``, with
the standalone operator's ``ingest`` pump over a plan directory, and the
Brain pod (``python -m easydl_tpu_torch.brain``) over real gRPC. The job is
built with the port's ``JobSpec``: its ``spec.command`` is the port's
runner, the trainer role the port's ``trainer_main`` (one worker), the
worker role the port's agent, the evaluator role the port's pod.

:func:`run` drives it and returns what happened (:class:`Lifecycle`);
:func:`failures` lists the checks it fails. ``chip_smoke.py`` phase 18 runs
BERT-base on the card through it; ``tests/test_torch_lifecycle.py`` a small
GPT on the CPU.

The worker pod is killed as a node loss kills it: SIGKILL to its process
group (the agent, its worker and the worker's ranks), through the process
``LocalProcessPodApi`` holds, once the worker's metrics show step
``kill_at`` and a save is committed. ``delete_pod`` would be a graceful
retire.
"""

from __future__ import annotations

import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from easydl_tpu_torch.api.job_spec import JobSpec, RoleSpec
from easydl_tpu_torch.controller import CrStore, ElasticJobController
from easydl_tpu_torch.controller.__main__ import ingest
from easydl_tpu_torch.controller.process_pod_api import LocalProcessPodApi
from easydl_tpu_torch.controller.reconciler import _SOURCE, _bind
from easydl_tpu_torch.core.checkpoint import CheckpointManager
from easydl_tpu_torch.utils.native import BUILD_DIR, load_native

JOB = "lifecycle"
#: the operator's pump (ingest + a reconcile pass), as the standalone
#: operator's loop runs it
TICK_S = 0.25
#: reconcile ticks over which the finished job's pods must stay the same
STABLE_TICKS = 4
POLL_S = 0.05
#: a first failure is replaced in the reconcile pass that sees it, with no
#: backoff: within a few ticks of the kill
REPLACE_S = 12 * TICK_S
#: the one reshape out of generation 1. The master adopts the Brain's
#: startup plan on its first poll (the trainer's ``--workers 1`` sets only the
#: JobResource it applies and the master's first count; the master's own plan
#: version starts at 0), so it wants more workers than one: the replacement
#: agent, registering while the killed one has not yet missed its heartbeat
#: timeout, makes a planned "plan-change" reshape, whose drain ends once the
#: killed member is lost; a replacement slower than that timeout would make it
#: "member-lost". Generation 2 is the replacement alone either way.
RESHAPES = ("plan-change", "member-lost")


@dataclass
class Lifecycle:
    """What one run did. Times are seconds on the host clock: ``since_submit``
    from the job's submission, ``since_kill`` from the SIGKILL."""

    total_steps: int
    #: pod name -> (role, seconds from submit when the operator created it,
    #: whether a plan was applied then), in the order of creation
    created: Dict[str, tuple] = field(default_factory=dict)
    since_submit: Dict[str, float] = field(default_factory=dict)
    since_kill: Dict[str, float] = field(default_factory=dict)
    killed_pod: str = ""
    replacement: str = ""
    #: the committed step at the kill, and the killed generation's losses
    saved: int = -1
    killed_losses: Dict[int, float] = field(default_factory=dict)
    #: every metrics record of every worker pod, by pod
    metrics: Dict[str, List[dict]] = field(default_factory=dict)
    reshapes: List[str] = field(default_factory=list)
    #: the pods and the job's status at the end, and whether the set of
    #: pods held over STABLE_TICKS further reconcile ticks
    final_pods: List[tuple] = field(default_factory=list)
    job_status: dict = field(default_factory=dict)
    stable: bool = False
    committed: List[int] = field(default_factory=list)
    eval_steps: List[int] = field(default_factory=list)
    native_core: bool = False
    native_library: str = ""
    brain_core: str = ""
    #: processes left in a pod's or the Brain's process group at the end
    leftover: List[str] = field(default_factory=list)
    wall_s: float = 0.0


def closed_port() -> int:
    """A local port nothing listens on (the agents' cloud-metadata probe)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read_jsonl(path: str) -> List[dict]:
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except FileNotFoundError:
        return []


def job_spec(runner_args: str, job_file: str, plan_dir: str, brain: str,
             platform: str) -> JobSpec:
    """The ElasticJob: ``spec.command`` the port's runner with
    ``runner_args``; the three roles' commands the port's pods."""
    py = shlex.quote(sys.executable)
    return JobSpec(
        name=JOB,
        command=f"python -m easydl_tpu_torch.models.run {runner_args}",
        roles={
            "trainer": RoleSpec(command=(
                f"{py} -m easydl_tpu_torch.elastic.trainer_main --job-file {job_file} "
                f"--plan-dir {plan_dir} --workdir {{workdir}} --brain {brain} "
                "--workers 1 --min-workers 1")),
            "worker": RoleSpec(command=(
                f"{py} -m easydl_tpu_torch.elastic.agent --id {{name}} "
                "--master-file {workdir}/master.json --workdir {workdir} --slots 1 "
                f"--platform {platform}")),
            "evaluator": RoleSpec(command=(
                f"{py} -m easydl_tpu_torch.elastic.evaluator_main --workdir {{workdir}} "
                f"--device {platform} --batches-per-eval 1")),
        },
    )


class RecordingPodApi(LocalProcessPodApi):
    """``LocalProcessPodApi`` that calls ``on_create(pod)`` before it starts
    each pod and hands out a pod's process."""

    def __init__(self, workdir: str, env: dict, on_create):
        super().__init__(workdir, env=env)
        self._on_create = on_create

    def create_pod(self, pod) -> None:
        self._on_create(pod)
        super().create_pod(pod)

    def process(self, name: str) -> Optional[subprocess.Popen]:
        with self._lock:
            entry = self._procs.get(name)
        return entry.proc if entry is not None else None


def _group_members(pgids: Dict[int, str]) -> List[str]:
    """Live (not zombie) processes whose process group is one of ``pgids``."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z" and int(fields[2]) in pgids:
            found.append(f"{pgids[int(fields[2])]}: pid {entry} {stat[:stat.rindex(')') + 1]}")
    return found


def run(work: str, runner_args: str, total_steps: int, kill_at: int, platform: str,
        deadline_s: float, pod_env: Optional[dict] = None) -> Lifecycle:
    """Submits the job under ``work`` and drives it to its end (see the
    module docstring). ``runner_args`` must give ``--steps total_steps``.
    Raises ``TimeoutError`` (with the pods' log tails) when a stage misses
    ``deadline_s``; ``failures`` judges the rest."""
    workdir, plan_dir = os.path.join(work, "work"), os.path.join(work, "plans")
    os.makedirs(workdir)
    os.makedirs(plan_dir)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    # the pods import the port from this checkout; the agents probe no
    # cloud metadata server
    env = {"PYTHONPATH": os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH"))
                                         if p),
           "EASYDL_GCE_METADATA_URL": f"http://127.0.0.1:{closed_port()}", **(pod_env or {})}
    rec = Lifecycle(total_steps=total_steps)
    # the operator's core, built (g++, first use) before the clock starts:
    # the first plan's reconcile pass would wait for it
    load_native(_SOURCE, _bind)
    t0 = time.time()
    brain = subprocess.Popen([sys.executable, "-m", "easydl_tpu_torch.brain", "--max-workers",
                              "1"], stdout=subprocess.PIPE, env={**os.environ, **env},
                             start_new_session=True)
    pgids = {brain.pid: "brain"}
    store = CrStore()

    def created(pod) -> None:
        rec.created[pod.name] = (pod.role, time.time() - t0, store.plan(JOB) is not None)

    api = RecordingPodApi(workdir, env, created)
    ctl = ElasticJobController(store, api)
    stop, ticks = threading.Event(), [0]

    def pump():
        seen, pending = {}, set()
        while not stop.is_set():
            ingest(store, plan_dir, seen, pending)
            for j in store.jobs():
                ctl.reconcile_job(j)
            ticks[0] += 1
            stop.wait(TICK_S)

    thread = threading.Thread(target=pump, daemon=True)

    def pods():
        out = api.list_pods(JOB)
        for p in out:  # each pod's process group, for the leak check
            proc = api.process(p.name)
            if proc is not None:
                pgids.setdefault(proc.pid, p.name)
        return out

    def logs() -> str:
        log_dir = os.path.join(workdir, "pod-logs")
        tails = []
        for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []:
            with open(os.path.join(log_dir, name), errors="replace") as f:
                tails.append(f"===== {name}\n{''.join(f.readlines()[-30:])}")
        return "\n".join(tails)

    def until(cond, what: str):
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            got = cond()
            if got:
                return got
            time.sleep(POLL_S)
        raise TimeoutError(f"no {what} within {deadline_s}s; the pods' logs:\n{logs()}")

    def mark(key: str, since: float, table: Dict[str, float]) -> None:
        table.setdefault(key, time.time() - since)

    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), async_save=False)
    try:
        line = brain.stdout.readline()
        if not line:
            raise RuntimeError("the Brain pod exited before printing its address")
        address = json.loads(line)
        rec.brain_core = address["core"]
        job_file = os.path.join(work, "job.yaml")
        spec = job_spec(runner_args, job_file, plan_dir, address["address"], platform)
        with open(job_file, "w") as f:
            f.write(spec.to_yaml())
        t0 = time.time()
        store.submit_job(spec)
        thread.start()

        def running(role: str, name: Optional[str] = None):
            return [p for p in pods() if p.role == role and p.phase == "Running"
                    and (name is None or p.name == name)]

        until(lambda: running("trainer"), "trainer pod Running")
        mark("trainer pod Running", t0, rec.since_submit)
        until(lambda: store.plan(JOB), "JobResource applied")
        mark("plan applied", t0, rec.since_submit)
        first = until(lambda: running("worker"), "worker pod Running")[0].name
        mark("worker pod Running", t0, rec.since_submit)
        metrics = os.path.join(workdir, f"metrics-{first}.jsonl")
        until(lambda: read_jsonl(metrics), "first step")
        mark("first step", t0, rec.since_submit)
        until(lambda: (len(read_jsonl(metrics)) >= kill_at and ckpt.steps()),
              f"step {kill_at} with a committed save")
        proc = api.process(first)
        if proc.poll() is not None:
            raise AssertionError(f"{first} ended (rc {proc.returncode}) before its kill; the "
                                 f"pods' logs:\n{logs()}")
        os.killpg(proc.pid, signal.SIGKILL)  # the agent and its worker's ranks
        t_kill = time.time()
        rec.killed_pod, rec.saved = first, max(ckpt.steps())
        proc.wait()
        rec.killed_losses = {r["step"]: r["loss"] for r in read_jsonl(metrics)}

        def replacement():
            names = [p.name for p in pods() if p.role == "worker" and p.name != first]
            return names[0] if names else None

        rec.replacement = until(replacement, "replacement worker pod")
        mark("replacement pod created", t_kill, rec.since_kill)
        until(lambda: running("worker", rec.replacement), "replacement pod Running")
        mark("replacement pod Running", t_kill, rec.since_kill)
        until(lambda: read_jsonl(os.path.join(workdir, f"metrics-{rec.replacement}.jsonl")),
              "generation 2's first step")
        mark("generation 2 first step", t_kill, rec.since_kill)

        def finished():
            now = pods()
            return (now and all(p.phase == "Succeeded" for p in now)
                    and (store.job_status(JOB) or {}).get("phase") == "Succeeded")

        until(finished, "every pod Succeeded and the job Succeeded")
        rec.wall_s = time.time() - t0
        names, tick = {p.name for p in pods()}, ticks[0]
        until(lambda: ticks[0] >= tick + STABLE_TICKS, f"{STABLE_TICKS} reconcile ticks")
        final = pods()
        rec.stable = {p.name for p in final} == names
        rec.final_pods = [(p.name, p.role, p.phase) for p in final]
        rec.job_status = store.job_status(JOB) or {}
        rec.leftover = _group_members({g: n for g, n in pgids.items() if n != "brain"})
    finally:
        stop.set()
        if thread.is_alive():
            thread.join(timeout=5)
        api.shutdown()
        if brain.poll() is None:
            brain.send_signal(signal.SIGINT)
            try:
                brain.wait(timeout=30)
            except subprocess.TimeoutExpired:
                brain.kill()
                brain.wait()
        brain.stdout.close()
    rec.leftover += _group_members({brain.pid: "brain"})
    rec.metrics = {name: read_jsonl(os.path.join(workdir, f"metrics-{name}.jsonl"))
                   for name, (role, *_) in rec.created.items() if role == "worker"}
    rec.reshapes = [e["reason"] for e in read_jsonl(os.path.join(workdir, "events.jsonl"))
                    if e["kind"] == "reshape"]
    rec.committed = ckpt.steps()
    rec.eval_steps = [int(e["step"]) for e in read_jsonl(os.path.join(workdir, "eval.jsonl"))]
    lib = load_native(_SOURCE, _bind)
    rec.native_core, rec.native_library = lib is not None, getattr(lib, "_name", "")
    return rec


def failures(rec: Lifecycle, replay_abs: float) -> List[str]:
    """The checks (a)-(g) of ``chip_smoke.py`` phase 18 that ``rec`` fails:
    (a) the trainer pod first and alone; (b) the plan levels one worker and
    one evaluator pod; (c) the killed pod replaced under a fresh name, one
    member-lost reshape; (d) generation 2 restores the committed step and
    replays the steps after it within ``replay_abs``, to the last step;
    (e) every pod and the job Succeeded, the pods stable, the last step
    checkpointed and evaluated; (f) the native reconcile core, the port's
    own; (g) no process left."""
    out = []
    order = [(name, role, planned) for name, (role, _, planned) in rec.created.items()]
    if not (order and order[0] == (f"{JOB}-trainer-0", "trainer", False)
            and all(planned for *_, planned in order[1:])):
        out.append(f"(a) the trainer pod not first and alone: pods created {order}")
    if sorted(role for _, role, _ in order) != ["evaluator", "trainer", "worker", "worker"]:
        out.append(f"(b) pods created {order}: not one worker, one evaluator and the "
                   "worker's replacement")
    again = [r for r in rec.metrics.get(rec.replacement, []) if r["generation"] == 2]
    if not (rec.replacement and rec.replacement not in (rec.killed_pod, "")
            and rec.since_kill.get("replacement pod created", REPLACE_S) < REPLACE_S
            and len(rec.reshapes) == 1 and rec.reshapes[0] in RESHAPES
            and again and all(r["world_size"] == 1 for r in again)):
        out.append(f"(c) killed {rec.killed_pod}, replaced by {rec.replacement!r} "
                   f"{rec.since_kill.get('replacement pod created')} s after the kill "
                   f"(bound {REPLACE_S}), reshapes {rec.reshapes}, generation 2's world "
                   f"{sorted({r['world_size'] for r in again})}")
    steps = [r["step"] for r in again]
    replayed = [s for s in rec.killed_losses if s > rec.saved]
    err = max((abs(r["loss"] - rec.killed_losses[r["step"]]) for r in again
               if r["step"] in rec.killed_losses), default=float("nan"))
    first_gen = {r["generation"] for r in rec.metrics.get(rec.killed_pod, [])}
    if not (first_gen == {1} and replayed
            and steps == list(range(rec.saved + 1, rec.total_steps + 1))
            and err <= replay_abs):
        out.append(f"(d) committed {rec.saved} at the kill, the killed generation's steps "
                   f"{sorted(rec.killed_losses)} (generations {first_gen}), generation 2's "
                   f"{steps}; replayed max |loss diff| {err!r} (bound {replay_abs})")
    if not (rec.final_pods and all(phase == "Succeeded" for *_, phase in rec.final_pods)
            and rec.job_status.get("phase") == "Succeeded" and rec.stable
            and rec.total_steps in rec.committed and rec.total_steps in rec.eval_steps):
        out.append(f"(e) pods {rec.final_pods}, stable {rec.stable}, job {rec.job_status}, "
                   f"committed {rec.committed}, evaluated {rec.eval_steps}")
    if not (rec.native_core and rec.native_library.startswith(BUILD_DIR + os.sep)):
        out.append(f"(f) the reconcile core: native {rec.native_core}, "
                   f"library {rec.native_library!r}, not the port's {BUILD_DIR}")
    if rec.leftover:
        out.append(f"(g) processes left: {rec.leftover}")
    return out
