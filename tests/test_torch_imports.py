"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; entry points default to
the CUDA device and refuse to run without it; on CPU tensors the kernel
wrappers run their plain versions and launch nothing; importing the kernel
modules needs no ``nvcc``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.engine.engine import InferenceEngine
    from repro_torch.engine.kv_cache import PagedKVCache
    from repro_torch.engine.state_cache import SSMStateCache
    from repro_torch.bench.profile import measure_engine_profile
    from repro_torch.cluster.hardware import GPUS
    from repro_torch.cluster.workload import train_corpus
    from repro_torch.core.predictor import (MoEPredictor, SingleMLPPredictor,
                                            TransformerProxyPredictor)
    from repro_torch.launch import goodput
    from repro_torch.launch.serve import main
    from repro_torch.launch import sharded
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import init_params
    cfg = reduce_config(get_config("llama3.1-8b"))
    mamba = reduce_config(get_config("mamba2-1.3b"))
    corpus = train_corpus(n=20, seed=1)
    for make in (lambda: InferenceEngine(cfg), lambda: init_params(cfg),
                 lambda: PagedKVCache(cfg, 4), lambda: SSMStateCache(mamba, 2),
                 lambda: InferenceEngine(mamba),
                 lambda: main(["--size", "reduced", "--n-requests", "1"]),
                 lambda: MoEPredictor().fit(corpus, epochs=1),
                 lambda: SingleMLPPredictor().fit(corpus, epochs=1),
                 lambda: TransformerProxyPredictor().fit(corpus, epochs=1),
                 lambda: measure_engine_profile(cfg, GPUS["H100"]),
                 lambda: goodput.main([]),
                 lambda: train_main(["--reduced", "--steps", "1"]),
                 lambda: sharded.start_world(), lambda: sharded.mesh_ctx()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_wrappers_on_cpu_run_plain_versions_and_launch_nothing():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    f0, p0, s0 = (flash_attention.launches, paged_attention.launches,
                  ssd.launches)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 20, 4, 32, generator=g)
    k = torch.randn(1, 30, 2, 32, generator=g)
    v = torch.randn(1, 30, 2, 32, generator=g)
    assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))
    kp = torch.randn(6, 8, 2, 32, generator=g)
    args = (q[:, 0].contiguous(), kp, -kp,
            torch.tensor([[3, 1, 4]], dtype=torch.int32),
            torch.tensor([19], dtype=torch.int32))
    assert torch.equal(paged_attention(*args), paged_attention_ref(*args))
    x = torch.randn(1, 32, 4, 16, generator=g)
    dt = torch.rand(1, 32, 4, generator=g)
    bc = torch.randn(1, 32, 1, 16, generator=g)
    sargs = (x, dt, -torch.ones(4), bc, -bc)
    for a, b in zip(ssd(*sargs, chunk=16), ssd_ref(*sargs, chunk=16)):
        assert torch.equal(a, b)
    assert (flash_attention.launches, paged_attention.launches,
            ssd.launches) == (f0, p0, s0)


def test_kernel_modules_import_without_nvcc():
    code = (
        "import repro_torch.models.model, repro_torch.engine.engine\n"
        "import repro_torch.launch.serve, repro_torch.launch.goodput\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._libs\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
