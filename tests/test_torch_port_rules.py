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
    from easydl_tpu_torch.ops.flash_attention import KERNEL_SOURCE

    assert (build.CSRC / KERNEL_SOURCE).is_file()
    assert build.BUILD_DIR == PORT / "_build"
