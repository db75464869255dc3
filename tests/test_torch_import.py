"""The PyTorch port stands alone: it imports with ``jax`` and ``repro``
blocked, names neither in an import, and its entry points refuse to run
quietly on the CPU when no card is there and none was asked for."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

torch.set_num_threads(2)


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return sorted(names)


def test_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    assert len(mods) > 20
    assert {"repro_torch.models.mamba2", "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.ssd_scan.ref",
            "repro_torch.configs.mamba2_370m",
            "repro_torch.configs.zamba2_1_2b", "repro_torch.models.moe",
            "repro_torch.launch.serve",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.mixtral_8x7b", "repro_torch.configs.yi_6b",
            "repro_torch.configs.phi4_mini_3_8b",
            "repro_torch.configs.llama_3_2_vision_11b",
            "repro_torch.configs.whisper_tiny",
            "repro_torch.models.model", "repro_torch.obs",
            "repro_torch.obs.trace", "repro_torch.obs.timeline",
            "repro_torch.core.workload", "repro_torch.core.simulator",
            "repro_torch.data.workload", "repro_torch.layout",
            "repro_torch.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.steps"} <= set(mods)
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.name} imports {name}"


def test_entry_points_refuse_the_cpu_unless_asked():
    """No card and no ``device="cpu"``: every entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry points use it")
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import SeerRollout
    from repro_torch.engine import Instance, StepFunctions
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.model import modality_inputs
    for arch in ("granite-3-8b", "mamba2-370m", "zamba2-1.2b",
                 "moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
                 "whisper-tiny"):
        cfg = get_tiny_config(arch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(cfg, {})
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Instance(cfg, params, StepFunctions(cfg), max_slots=1,
                     cache_len=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SeerRollout(cfg, params, max_slots=1, cache_len=8)
        if cfg.arch_type in ("vlm", "audio"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                modality_inputs(cfg, 1)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--groups", "1"])


def test_training_modules_build_nothing_on_import():
    """The training slice's modules import without building a kernel: K4's
    backward (``ssd_scan.ops.BWD_LIBRARY``, its own ``.cu`` source beside
    the forward's) is compiled at first use only, the trainer's and the
    cache-free forward's entry points are there on every arch, and the
    bridge and the tree layouts import no training module."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch import bridge, layout\n"
            "assert 'repro_torch.training' not in sys.modules\n"
            "from repro_torch.kernels.ssd_scan import ops, ref\n"
            "from repro_torch.kernels import build\n"
            "from repro_torch.training import grpo, checkpoint, loop\n"
            "from repro_torch.models import transformer\n"
            "assert ops.BWD_LIBRARY.lib is None and ops.LIBRARY.lib is None\n"
            "assert ops.BWD_SOURCE.name == 'ssd_scan_bwd.cu'\n"
            "assert ops.BWD_SOURCE in build.sources_of(ops.BWD_SOURCE)\n"
            "assert ops.launches == {'ssd_scan': 0, 'ssd_scan_bwd': 0}\n"
            "assert ref.calls == {'ssd': 0, 'ssd_bwd': 0}\n"
            "for f in (ops.ssd_scan_bwd, ref.ssd_bwd_ref, "
            "layout.jax_layout, layout.port_layout, "
            "bridge.params_to_numpy, loop.make_train_step):\n"
            "    assert callable(f)\n"
            "assert set(transformer.PORTED_ARCHS) == {'dense', 'moe', "
            "'ssm', 'hybrid', 'vlm', 'audio'}\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _smoke(cwd: Path, env=None):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _smoke(tmp_path, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
