"""Rules of the PyTorch port that hold without a GPU:

- no module of ``easydl_tpu_torch/`` and not ``chip_smoke.py`` imports jax,
  flax, optax or anything of ``easydl_tpu`` (AST scan);
- the runner trains on the CPU when asked to (``--device cpu``), and without
  that flag, like ``chip_smoke.py``, fails on a box without a CUDA GPU with
  a message that names the missing card;
- the kernel build reads its sources from the package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


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
    ["chip_smoke.py"],
])
def test_cuda_entry_points_fail_without_a_card(args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(args, timeout=300)
    assert r.returncode != 0
    assert "no CUDA GPU" in r.stderr, r.stderr[-2000:]
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("flag", [["--role", "evaluator"], ["--ckpt-dir", "x"],
                                  ["--data-dir", "x"], ["--pp", "2"], ["--profile-dir", "x"]])
def test_runner_rejects_unported_flags(flag):
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
    dq = "_ZN46_GLOBAL__N__c6954c91_1a_flash_attention_cu_19flash_bwd_dq_kernelIfLi32EEEvPKT_"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 106 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{dq}' for 'sm_90a'",
        f"ptxas info    : Function properties for {dq}",
        "    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
    ])
    assert smoke.ptxas_report(log) == {"flash_fwd_sm90_kernel<bf16, 64>": [106, 0, 0],
                                       "flash_bwd_dq_kernel<f32, 32>": [64, 12, 8]}
    assert smoke.kernel_name("_Z3foov") == "_Z3foov"
