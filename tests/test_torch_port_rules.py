"""Rules of the PyTorch port that hold without a GPU:

- no module of ``easydl_tpu_torch/`` and not ``chip_smoke.py`` imports jax,
  flax, optax or anything of ``easydl_tpu`` (AST scan), the copies of the
  JAX package's JAX-free modules (``data/``, ``obs/``, ``chaos/``,
  ``core/chunk_cache.py``) included;
- the port uses no ``EASYDL_*`` variable that the JAX package does not
  declare: it reads the agent protocol's, and declares no knob of its own;
- the runner trains on the CPU when asked to (``--device cpu``), and without
  that flag, like its evaluator role, the evaluator pod, the elastic
  worker, the bench and ``chip_smoke.py``, fails on a box without a CUDA
  GPU with a message that names the missing card;
- the bench (``scripts/bench.py``) rehearses on the CPU and prints
  ``bench.py``'s fields;
- the kernel build reads its sources from the package;
- under ``torch.distributed.run`` the runner trains on every rank (two gloo
  ranks on the CPU here), rank 0 alone logs, its multi-rank checkpoint
  resumes and the one-process evaluator restores it; one rank takes the
  one-device path; ``--dp`` must match the world, and the evaluator refuses
  to run as several processes;
- the multi-card script (``scripts/nccl_cards.py``) runs its four ranks on
  the CPU over gloo and holds them to one process, in bf16 and f32, and
  resizes the elastic worker on file data from two agents of two ranks to
  one, the restoring ranks reading their host's chunk cache.
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
                   "core/mesh", "core/mesh_shapes", "core/sharding",  # multi-process
                   "core/chunk_cache", "data/datasets", "data/tokenizer", "data/encode",
                   "obs/tracing", "chaos/injectors"):  # copies of JAX-free modules
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


def test_scan_catches_a_forbidden_import(tmp_path):
    for src in ("import jax.numpy as jnp", "from easydl_tpu.ops import attention",
                "from flax import linen"):
        f = tmp_path / "m.py"
        f.write_text(src + "\n")
        assert [m for m in _imports(f) if m.split(".")[0] in FORBIDDEN], src


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


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


@pytest.mark.parametrize("flag", [["--role", "evaluator"], ["--ckpt-dir", "gs://bucket/run"],
                                  ["--data-dir", "x"], ["--pp", "2"], ["--profile-dir", "x"]])
def test_runner_rejects_unported_flags(flag):
    """``--role evaluator`` without ``--ckpt-dir`` is an error in both
    packages, and so is a ``--data-dir`` without data (the port says so
    before it builds a model); the rest are not ported yet."""
    from easydl_tpu_torch.models import run

    with pytest.raises(SystemExit):
        run.main(["--model", "gpt", "--device", "cpu", *flag])


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


def test_runner_at_one_rank_takes_the_one_device_path():
    r = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
              "-m", "easydl_tpu_torch.models.run", "--model", "gpt", "--model-arg", "size=test",
              "--model-arg", "seq_len=64", "--model-arg", "vocab=256", "--batch", "4",
              "--device", "cpu", "--steps", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step 1 loss" in r.stderr and "mesh" not in r.stderr  # no FSDP2 at one rank


def test_bench_rehearses_on_the_cpu():
    r = _run(["-m", "easydl_tpu_torch.scripts.bench", "--device", "cpu", "--size", "test"])
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) >= {"metric", "value", "unit", "tokens_per_sec", "step_time_s", "mfu",
                        "peak_tflops_per_chip", "device_kind"}
    assert out["unit"] == "samples/sec/chip" and out["value"] > 0
    assert out["mfu"] is None and out["device_kind"] is None  # no card, no peak
    assert abs(out["loss"] - np.log(256)) < 1.0


def test_multi_card_script_rehearses_on_four_cpu_ranks():
    r = _run(["-m", "easydl_tpu_torch.scripts.nccl_cards", "--device", "cpu", "--size", "test"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["backend"] == "gloo" and out["mesh"] == [2, 2]
    assert out["param_rel"] <= 2e-3 and len(out["losses"]) == 4
    assert out["f32_param_rel"] <= 1e-5  # at f32 compute the ranks match one process
    assert out["resize"]["hashes"] > 0 and len(out["resize"]["losses"]) == 6
    # two restoring ranks, each reading chunks from its host's cache
    assert len(out["resize"]["reads"]) == 2
    assert all(r["cache"] > 0 for r in out["resize"]["reads"].values())


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
