"""Rules of the PyTorch port that hold without a GPU:

- no module of ``easydl_tpu_torch/`` and not ``chip_smoke.py`` imports jax,
  flax, optax or anything of ``easydl_tpu`` (AST scan), the copies of the
  JAX package's JAX-free modules (``data/``, ``obs/``, ``chaos/``,
  ``core/chunk_cache.py``, ``ps/``, ``proto/``, ``loop/spool.py``,
  ``utils/env.py``, ``rpc.py``, ``retry.py``, ``native.py``, ``api/``,
  ``brain/``, the elastic control plane, ``serve/``, ``loop/publish.py``,
  ``loop/rollout.py``, the operator's ``controller/`` and ``obs/scrape.py``)
  included;
- the PS pod (``python -m easydl_tpu_torch.ps``) starts where importing
  torch or JAX fails, and the store's C++ source ships with the package;
- so do the master, the agent, the Brain pod, the trainer pod and the
  operator (``python -m easydl_tpu_torch.controller``), and the Brain's and
  the operator's native cores ship with the package; the agent, given no
  platform, starts the worker on the card (no ``--device cpu``);
- the image bundles (ResNet, the MLP) build on the CPU when asked to and
  raise without a card otherwise;
- the port uses no ``EASYDL_*`` variable that the JAX package does not
  declare: it reads the agent protocol's, and declares no knob of its own;
- the runner trains on the CPU when asked to (``--device cpu``), and without
  that flag, like its evaluator role, the evaluator pod, the elastic
  worker, the bench, the four-card scripts, the serving replica's
  ``--deepfm`` and ``chip_smoke.py``, fails on a box without a CUDA
  GPU with a message that names the missing card;
- the bench (``scripts/bench.py``) rehearses on the CPU and prints
  ``bench.py``'s fields;
- the kernel build reads its sources from the package;
- ``chip_smoke.py`` hands a child to a spare interpreter that imported it
  beforehand, with the child's arguments, output and exit code;
- under ``torch.distributed.run`` the runner trains on every rank (two gloo
  ranks on the CPU here), rank 0 alone logs, its multi-rank checkpoint
  resumes and the one-process evaluator restores it, and at ``--pp 2`` the
  two ranks are one pipeline's stages; one rank takes the
  one-device path; ``--dp`` must match the world, and the evaluator refuses
  to run as several processes;
- the multi-card script (``scripts/nccl_cards.py``) runs its four ranks on
  the CPU over gloo and holds them to one process, in bf16 and f32, also at
  ep 4, dp 2 x ep 2 and sp 4 (Ulysses), and resizes the elastic worker on
  file data from two agents of two ranks to one, the restoring ranks
  reading their host's chunk cache; ``scripts/tp_cards.py`` runs its tp
  meshes alone on four gloo ranks, also at f32 compute (within 1e-5 of one
  process) and with the row-parallel all-reduce skipped (above
  ``nccl_cards.TP_PARAM_REL``), and ``scripts/pp_cards.py`` its pp 2 x dp 2
  mesh;
- the instrumented worker adds the GPT size ``--gpt-size`` names and hands
  its own flags on to the ranks it starts.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # this file belongs with the parity tests

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "easydl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "easydl_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    for module in ("core/prng", "models/bert",  # jax.random's bits, without JAX
                   "models/resnet", "models/mlp", "models/classifier", "data/images",
                   "models/deepfm", "data/clicks",
                   "core/mesh", "core/mesh_shapes", "core/sharding",  # multi-process
                   "ops/moe", "ops/sequence_parallel", "parallel/__init__",  # ep and sp
                   "core/chunk_cache", "data/datasets", "data/tokenizer", "data/encode",
                   "obs/tracing", "chaos/injectors",  # copies of JAX-free modules
                   "obs/registry", "obs/exporter", "obs/errors", "chaos/__init__",
                   "loop/spool", "proto/easydl_pb2", "utils/env", "utils/rpc",
                   "utils/retry", "utils/native", "ps/__init__", "ps/__main__", "ps/build",
                   "ps/table", "ps/quant", "ps/wal", "ps/server", "ps/registry",
                   "ps/client", "ps/read_client", "ps/trainer",  # the PS tier
                   "api/__init__", "api/job_spec", "api/resource_plan",  # the control plane
                   "brain/__init__", "brain/__main__", "brain/straggler", "brain/mesh_policy",
                   "brain/policy", "brain/convert", "brain/service", "elastic/__init__",
                   "elastic/membership", "elastic/master", "elastic/agent",
                   "elastic/gce_metadata", "elastic/trainer_main", "elastic/timeline",
                   "serve/__init__", "serve/__main__", "serve/cache", "serve/frontend",
                   "serve/launch", "serve/router", "serve/routing",  # the serving tier
                   "loop/publish", "loop/rollout",
                   "loop/feedback", "loop/continuous", "ps/shm", "ps/reshard",  # the loop,
                   "brain/tier_policy",  # the rest of the PS tier
                   "controller/__init__", "controller/__main__", "controller/fleet",
                   "controller/kube_cr_source", "controller/kube_http",
                   "controller/kube_pod_api", "controller/operator", "controller/pod_api",
                   "controller/process_pod_api", "controller/reconciler",  # the operator
                   "brain/arbiter", "obs/scrape", "scripts/operator_lifecycle"):
        assert PORT / f"{module}.py" in files
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_declares_no_easydl_knob_of_its_own():
    import re

    from easydl_tpu.utils.env import KNOB_DECLS

    declared = {decl[0] for decl in KNOB_DECLS}
    used = {(str(f.relative_to(REPO)), name) for f in _port_files()
            for name in re.findall(r"EASYDL_[A-Z0-9_]+", f.read_text())}
    assert any(name == "EASYDL_COORD" for _, name in used)  # the worker's protocol
    assert not [(f, name) for f, name in used if name not in declared]


def test_no_refusal_is_left_in_the_ps_tier():
    """The PS tier is ported whole: no module of ``ps/`` (nor the worker or
    the loop) refuses a part of the JAX tier any more."""
    files = [*sorted((PORT / "ps").glob("*.py")), PORT / "elastic" / "worker.py",
             *sorted((PORT / "loop").glob("*.py"))]
    assert len(files) > 15
    left = [(str(f.relative_to(REPO)), word) for f in files
            for word in ("not_ported", "LATER_ITEM", "Queue A 5b", "_refuse_unported")
            if word in f.read_text()]
    assert not left, left


def test_scan_catches_a_forbidden_import(tmp_path):
    for src in ("import jax.numpy as jnp", "from easydl_tpu.ops import attention",
                "from flax import linen"):
        f = tmp_path / "m.py"
        f.write_text(src + "\n")
        assert [m for m in _imports(f) if m.split(".")[0] in FORBIDDEN], src


def _run(args, timeout=600, **env):
    env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


#: the bench's threads: its b256/a32 steps take 12-15 s alone with every
#: core, and took 200-540 s beside the suite's other workers when each of
#: its threads fought them for a core
BENCH_THREADS = {"OMP_NUM_THREADS": "2"}


def test_runner_trains_on_cpu_when_asked():
    r = _run(["-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--model-arg",
              "size=test", "--steps", "2", "--batch", "2", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step 2 loss" in r.stderr


@pytest.mark.parametrize("args", [
    ["-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--model-arg", "size=test",
     "--steps", "2"],
    ["-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--model-arg", "size=test",
     "--role", "evaluator", "--ckpt-dir", "{tmp}", "--eval-polls", "1"],
    ["-m", "easydl_tpu_torch.elastic.evaluator_main", "--workdir", "{tmp}"],
    ["-m", "easydl_tpu_torch.elastic.worker"],
    ["-m", "easydl_tpu_torch.scripts.bench"],
    ["-m", "easydl_tpu_torch.scripts.tp_cards"],
    ["-m", "easydl_tpu_torch.scripts.pp_cards"],
    ["-m", "easydl_tpu_torch.scripts.ps_precision"],
    ["-m", "easydl_tpu_torch.serve", "--workdir", "{tmp}", "--name", "serve-0", "--table", "emb",
     "--fields", "4", "--deepfm"],
    ["chip_smoke.py"],
])
def test_cuda_entry_points_fail_without_a_card(args, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # the elastic worker reads the agent's variables and job.json first
    (tmp_path / "job.json").write_text(json.dumps({"model": "gpt"}))
    for name, value in {"EASYDL_RANK": "0", "EASYDL_WORLD": "1", "EASYDL_COORD": "localhost:1",
                        "EASYDL_GEN": "1", "EASYDL_WORKDIR": str(tmp_path),
                        "EASYDL_METRICS": str(tmp_path / "metrics.jsonl")}.items():
        monkeypatch.setenv(name, value)
    r = _run([a.format(tmp=tmp_path) for a in args], timeout=300)
    assert r.returncode != 0
    assert "no CUDA GPU" in r.stderr, r.stderr[-2000:]
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("name", ["resnet", "mlp"])
def test_image_bundles_build_on_the_card_unless_asked_for_the_cpu(name):
    from easydl_tpu_torch.models.registry import get_model

    bundle = get_model(name, **({"size": "test"} if name == "resnet" else {}))
    assert bundle.init_fn(0, "cpu") is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            bundle.init_fn(0)


@pytest.mark.parametrize("flag", [["--role", "evaluator"], ["--ckpt-dir", "gs://bucket/run"],
                                  ["--data-dir", "x"], ["--pp", "2"], ["--profile-dir", "x"]])
def test_runner_rejects_unported_flags(flag):
    """``--role evaluator`` without ``--ckpt-dir`` is an error in both
    packages, and so is a ``--data-dir`` without data (the port says so
    before it builds a model) and ``--pp 2`` on one process (a device a
    stage); the rest are not ported yet."""
    from easydl_tpu_torch.models import run

    with pytest.raises(SystemExit):
        run.main(["--model", "gpt", "--device", "cpu", *flag])


def test_the_ps_pod_starts_without_torch_or_jax():
    """The pod's import chain holds neither: its package ``__init__`` pulls
    in no client or trainer, so a PS pod never makes a CUDA context."""
    block = ("import runpy, sys; sys.modules['torch'] = sys.modules['jax'] = None; "
             "sys.argv[0] = 'pod'; runpy.run_module('easydl_tpu_torch.ps', "
             "run_name='__main__', alter_sys=True)")
    r = _run(["-c", block, "--help"], timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--num-shards" in r.stdout and "--replaces" in r.stdout
    r = _run(["-c", "import sys; sys.modules['torch'] = None; import easydl_tpu_torch.ps.client"],
             timeout=120)
    assert r.returncode != 0 and "torch" in r.stderr  # the block does bite


@pytest.mark.parametrize("module,flag", [
    ("easydl_tpu_torch.elastic.master", "--worker-config"),
    ("easydl_tpu_torch.elastic.agent", "--master-file"),
    ("easydl_tpu_torch.brain", "--state-dir"),
    ("easydl_tpu_torch.elastic.trainer_main", "--plan-dir"),
    ("easydl_tpu_torch.controller", "--watch-dir"),
])
def test_the_control_plane_pods_start_without_torch_or_jax(module, flag):
    """The pods' import chains hold neither (the agent starts the worker
    and the worker imports torch; the pods themselves never do)."""
    block = ("import runpy, sys; sys.modules['torch'] = sys.modules['jax'] = None; "
             f"sys.argv[0] = 'pod'; runpy.run_module({module!r}, run_name='__main__', "
             "alter_sys=True)")
    r = _run(["-c", block, "--help"], timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert flag in r.stdout


def test_the_control_plane_serves_without_torch_or_jax(tmp_path):
    """Master, Brain and agent serve and talk over gRPC in a process where
    importing torch or JAX fails, and the trainer pod parses a job's
    runner command there."""
    code = f"""
import sys
sys.modules['torch'] = sys.modules['jax'] = None
from easydl_tpu_torch.brain import Brain
from easydl_tpu_torch.brain.policy import native_core_loaded
from easydl_tpu_torch.elastic import trainer_main
from easydl_tpu_torch.elastic.agent import Agent
from easydl_tpu_torch.elastic.master import Master
brain = Brain().start()
master = Master(job_name="j", workdir={str(tmp_path)!r}, brain_address=brain.address,
                 brain_poll_interval=0.1).start()
agent = Agent("a0", master.address, {str(tmp_path)!r},
              worker_argv=[sys.executable, "-c", "import time; time.sleep(30)"]).start()
import time
deadline = time.monotonic() + 30
while master.status()["phase"] != "stable" and time.monotonic() < deadline:
    time.sleep(0.1)
job = trainer_main.parse_runner_command(
    "python -m easydl_tpu_torch.models.run --model gpt --batch 8 --model-arg size=test")
print(master.status()["phase"], agent.worker_argv[-2:], native_core_loaded(),
      job[0].model, job[0].batch, job[1])
agent.stop(); master.stop(); brain.stop()
"""
    r = _run(["-c", code], timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["stable", "['--nproc',", "'1']", "True", "gpt", "8",
                                "{'size':", "'test'}"]


def test_the_agent_starts_the_worker_on_the_card_unless_asked_for_the_cpu(tmp_path):
    from easydl_tpu_torch.elastic.agent import Agent

    argv = Agent("a0", "localhost:1", str(tmp_path), slots=8).worker_argv
    assert argv == [sys.executable, "-m", "easydl_tpu_torch.elastic.worker", "--nproc", "8"]
    assert "--device" not in argv
    assert Agent("a0", "localhost:1", str(tmp_path), platform="cpu").worker_argv[-2:] == [
        "--device", "cpu"]


def test_the_brain_core_source_ships_with_the_package():
    import tomllib

    from easydl_tpu_torch.brain import policy
    from easydl_tpu_torch.utils import native

    assert Path(policy._SOURCE) == PORT / "brain" / "native" / "brain_core.cc"
    assert Path(native.BUILD_DIR) == PORT / "_build"
    data = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    assert "native/*.cc" in data["package-data"]["easydl_tpu_torch.brain"]


def test_the_reconciler_core_source_ships_with_the_package():
    import tomllib

    from easydl_tpu_torch.controller import reconciler
    from easydl_tpu_torch.utils import native

    assert Path(reconciler._SOURCE) == PORT / "controller" / "native" / "reconciler_core.cc"
    assert Path(native.BUILD_DIR) == PORT / "_build"
    data = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    assert "native/*.cc" in data["package-data"]["easydl_tpu_torch.controller"]


def test_the_ps_store_source_ships_with_the_package():
    import tomllib

    from easydl_tpu_torch.ps import build
    from easydl_tpu_torch.utils import native

    assert Path(build._SOURCE) == PORT / "ps" / "native" / "embedding_store.cc"
    assert Path(native.BUILD_DIR) == PORT / "_build"
    data = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    assert "native/*.cc" in data["package-data"]["easydl_tpu_torch.ps"]
    assert "*.proto" in data["package-data"]["easydl_tpu_torch.proto"]


def test_the_port_pb2_is_the_generators_output_for_its_proto():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import proto_compile
    finally:
        sys.path.pop(0)
    proto = PORT / "proto" / "easydl.proto"
    assert (PORT / "proto" / "easydl_pb2.py").read_text() == proto_compile.generate_pb2(
        proto.read_text())


def test_kernel_sources_ship_with_the_package():
    from easydl_tpu_torch.ops import build
    from easydl_tpu_torch.ops.flash_attention import KERNEL_SOURCES

    for source in KERNEL_SOURCES:
        text = (build.CSRC / source).read_text()
        for line in text.splitlines():  # local headers ship beside the sources
            if line.startswith('#include "'):
                assert (build.CSRC / line.split('"')[1]).is_file(), (source, line)
    assert build.BUILD_DIR == PORT / "_build"


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_reads_ptxas_and_names_kernels():
    """The build report that holds the tensor-core kernels to no spills:
    ``-Xptxas -v`` lines per kernel, names demangled to name<dtype, d>."""
    smoke = _chip_smoke()
    fwd = ("_ZN45_GLOBAL__N__db71cd62_12_flash_fwd_sm90_cu_392b546a21"
           "flash_fwd_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiif")
    dq = ("_ZN46_GLOBAL__N__5a1b2c3d_21_flash_bwd_f32_sm90_cu_8e2f7a1c28"
          "flash_bwd_dq_f32_sm90_kernelILi32EEEvPKfS2_S2_S2_S2_S2_PfS3_iiif")
    fwd32 = ("_ZN46_GLOBAL__N__c6954c91_21_flash_fwd_f32_sm90_cu_3f0e9b1a25"
             "flash_fwd_f32_sm90_kernelILi32EEEvPKfS2_S2_PfS3_iiif")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 106 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{dq}' for 'sm_90a'",
        f"ptxas info    : Function properties for {dq}",
        "    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{fwd32}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd32}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
    ])
    assert smoke.ptxas_report(log) == {"flash_fwd_sm90_kernel<bf16, 64>": [106, 0, 0],
                                       "flash_bwd_dq_f32_sm90_kernel<f32, 32>": [64, 12, 8],
                                       "flash_fwd_f32_sm90_kernel<f32, 32>": [72, 0, 0]}
    assert smoke.kernel_name("_Z3foov") == "_Z3foov"


def test_chip_smoke_children_run_in_spares(tmp_path):
    """``chip_smoke.Spares``: a child handed to an idle spare runs there (the
    same process) with its arguments, its output in the caller's file and
    its exit code; with none idle it starts fresh; ``stop`` ends the idle
    spares, and a spare whose parent is gone exits."""
    smoke = _chip_smoke()
    spares = smoke.Spares()
    try:
        spares.fill(1)
        spare = spares.idle[0][0]
        help_cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--evaluator", "--help"]
        with open(tmp_path / "help.log", "w") as f:
            proc = spares.popen(help_cmd, stdout=f, stderr=subprocess.STDOUT)
        assert proc is spare and proc.wait(timeout=120) == 0
        assert "usage: evaluator_main" in (tmp_path / "help.log").read_text()
        with open(tmp_path / "bad.log", "w") as f:
            fresh = spares.popen([*help_cmd[:3], "--no-such-flag"], stdout=f,
                                 stderr=subprocess.STDOUT)
        assert fresh is not spare and fresh.wait(timeout=120) == 2
        assert "evaluator_main: error" in (tmp_path / "bad.log").read_text()
        spares.fill(1)
        idle = spares.idle[0][0]
        spares.stop()
        assert idle.poll() is not None and not spares.idle
    finally:
        spares.stop()
    orphan = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--spare",
                               str(tmp_path / "never.json"), "1"])
    assert orphan.wait(timeout=120) == 1  # its parent is not pid 1


def test_runner_trains_on_two_ranks_and_the_evaluator_restores_them(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--model", "gpt", "--model-arg", "size=test", "--model-arg", "seq_len=64",
              "--model-arg", "vocab=256", "--batch", "4", "--device", "cpu"]
    run = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "easydl_tpu_torch.models.run", *common, "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    r = _run([*run, "--steps", "2"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("step 2 loss") == 1  # rank 0 logs
    assert "mesh DeviceMesh((dp=2, fsdp=1)" in r.stderr
    r = _run([*run, "--steps", "4"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from step 2" in r.stderr and "step 4 loss" in r.stderr
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004"]
    r = _run(["-m", "easydl_tpu_torch.models.run", *common, "--role", "evaluator",
              "--ckpt-dir", ckpt, "--eval-polls", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "eval @ step 4" in r.stderr


def test_runner_trains_at_pp_2_on_two_ranks():
    """``--pp 2`` splits two ranks into the two stages of one pipeline
    (``--pp-microbatches`` 2); a world that pp does not divide is refused."""
    common = ["-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--model-arg", "size=test",
              "--model-arg", "seq_len=64", "--model-arg", "vocab=256", "--batch", "4",
              "--device", "cpu", "--steps", "2", "--pp", "2"]
    r = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", *common])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("step 2 loss") == 1  # rank 0 logs
    assert "mesh DeviceMesh((dp=1, fsdp=1)" in r.stderr
    r = _run(common)
    assert r.returncode != 0 and "--pp 2 needs a device count divisible by it" in r.stderr


def test_runner_at_one_rank_takes_the_one_device_path():
    r = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
              "-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--model-arg", "size=test",
              "--model-arg", "seq_len=64", "--model-arg", "vocab=256", "--batch", "4",
              "--device", "cpu", "--steps", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step 1 loss" in r.stderr and "mesh" not in r.stderr  # no FSDP2 at one rank


def test_bench_rehearses_on_the_cpu():
    r = _run(["-m", "easydl_tpu_torch.scripts.bench", "--device", "cpu", "--size", "test"],
             **BENCH_THREADS)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) >= {"metric", "value", "unit", "tokens_per_sec", "step_time_s", "mfu",
                        "peak_tflops_per_chip", "device_kind"}
    assert out["unit"] == "samples/sec/chip" and out["value"] > 0
    assert out["mfu"] is None and out["device_kind"] is None  # no card, no peak
    assert abs(out["loss"] - np.log(256)) < 1.0


def test_bench_takes_its_step_counts():
    """``chip_smoke.py``'s 6e runs the bench at one warm-up and one timed
    step; none of either is refused."""
    r = _run(["-m", "easydl_tpu_torch.scripts.bench", "--device", "cpu", "--size", "test",
              "--warmup", "1", "--timed", "1"], **BENCH_THREADS)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["value"] > 0 and abs(out["loss"] - np.log(256)) < 1.0
    r = _run(["-m", "easydl_tpu_torch.scripts.bench", "--device", "cpu", "--size", "test",
              "--timed", "0"], **BENCH_THREADS)
    assert r.returncode != 0 and "at least one step" in r.stderr


def test_bench_mesh_rehearses_under_torch_distributed_run():
    r = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4", "-m",
              "easydl_tpu_torch.scripts.bench", "--device", "cpu", "--size", "test",
              "--mesh", "dp=2,tp=2"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = [line for line in r.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 prints
    out = json.loads(lines[0])
    assert out["mesh"] == "dp=2,tp=2" and out["n_chips"] == 4
    assert out["unit"] == "samples/sec/chip" and out["value"] > 0
    assert abs(out["loss"] - np.log(256)) < 1.0


def test_multi_card_script_rehearses_on_four_cpu_ranks():
    r = _run(["-m", "easydl_tpu_torch.scripts.nccl_cards", "--device", "cpu", "--size", "test"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["backend"] == "gloo" and out["mesh"] == [2, 2]
    assert out["param_rel"] <= 2e-3 and len(out["losses"]) == 4
    assert out["f32_param_rel"] <= 1e-5  # at f32 compute the ranks match one process
    # the tensor-parallel meshes against the same one process
    assert set(out["tp"]) == {"fsdp=2,tp=2", "dp=2,tp=2"}
    assert all(t["param_rel"] <= 2e-3 and len(t["losses"]) == 4 for t in out["tp"].values())
    # expert and sequence parallelism at f32 against one process
    assert set(out["ep_sp"]) == {"ep=4", "dp=2,ep=2", "sp=4 ulysses"}
    assert all(t["param_rel"] <= 1e-5 and len(t["losses"]) == 2 for t in out["ep_sp"].values())
    # both resizes; two restoring ranks, each reading chunks from its host's cache
    assert {k: e["meshes"] for k, e in out["resize"].items()} == {
        "fsdp": {"1": "dp=2,fsdp=2", "2": "dp=2"}, "tp": {"1": "fsdp=2,tp=2", "2": "tp=2"}}
    for e in out["resize"].values():
        assert e["hashes"] > 0 and len(e["losses"]) == 6
        assert len(e["reads"]) == 2
        assert all(r["cache"] > 0 for r in e["reads"].values())


def test_tp_script_rehearses_on_four_cpu_ranks():
    r = _run(["-m", "easydl_tpu_torch.scripts.tp_cards", "--device", "cpu", "--size", "test"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ranks"] == [0] * 4 and out["tree"] == str(REPO)
    assert len(out["one"]["losses"]) == 4
    for key in ("fsdp=2,tp=2", "dp=2,tp=2"):
        assert out[key]["param_rel"] <= 2e-3 and len(out[key]["losses"]) == 4


def test_pp_script_rehearses_on_four_cpu_ranks():
    """``scripts/pp_cards.py``: pp 2 x dp 2 on four gloo ranks against one
    process, each stage's view of the parameters within the bound."""
    r = _run(["-m", "easydl_tpu_torch.scripts.pp_cards", "--device", "cpu", "--size", "test"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["backend"] == "gloo" and out["mesh"] == {"dp": 2, "pp": 2}
    assert len(out["losses"]) == 4 and len(out["stage_rel"]) == 2
    assert max(out["stage_rel"]) <= 2e-3


@pytest.mark.parametrize("flag", ["--dtype=float32", "--fault=skip-row-allreduce"])
def test_tp_script_runs_at_f32_and_plants_its_fault_on_four_cpu_ranks(flag):
    """At f32 compute the tp meshes match one process to rounding (the card's
    bf16 gap is bf16's); with the row-parallel all-reduce skipped they read
    above ``nccl_cards.TP_PARAM_REL``."""
    from easydl_tpu_torch.scripts.nccl_cards import TP_PARAM_REL

    r = _run(["-m", "easydl_tpu_torch.scripts.tp_cards", "--device", "cpu", "--size", "test",
              flag])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    rels = [out[key]["param_rel"] for key in ("fsdp=2,tp=2", "dp=2,tp=2")]
    if flag == "--dtype=float32":
        assert out["dtype"] == "float32" and all(rel <= 1e-5 for rel in rels), rels
    else:
        assert out["fault"] == "skip-row-allreduce" and all(rel > TP_PARAM_REL for rel in rels)


def test_instrumented_worker_adds_a_gpt_size_and_hands_its_flags_on(monkeypatch):
    from easydl_tpu_torch.elastic import worker
    from easydl_tpu_torch.models import gpt
    from easydl_tpu_torch.scripts import instrumented_worker as iw

    seen = {}
    monkeypatch.setattr(worker, "main", lambda args, rank_cmd: seen.update(
        args=args, rank_cmd=rank_cmd))
    monkeypatch.setitem(gpt.SIZES, "test-shallow", None)
    own = ["--no-state-hashes", "--gpt-size", "test-shallow=1,32,2"]
    monkeypatch.setattr(sys, "argv", ["iw", "out", *own, "--device", "cpu"])
    iw.main()
    assert gpt.SIZES["test-shallow"] == (1, 32, 2)
    assert seen["args"] == ["--device", "cpu"]
    assert seen["rank_cmd"] == [sys.executable, "-m", iw.__name__, "out", *own]


@pytest.mark.parametrize("args,env", [
    (["--dp", "2"], {}),
    (["--role", "evaluator", "--ckpt-dir", "x"], {"WORLD_SIZE": "2"}),
])
def test_runner_rejects_a_world_it_cannot_run(args, env, monkeypatch):
    from easydl_tpu_torch.models import run

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit):
        run.main(["--model", "gpt", "--device", "cpu", *args])
