"""The port stands alone and runs on the card unless asked for the CPU.

An AST walk of src/repro_torch/, examples/torch/ and chip_smoke.py finds no
import of jax or of the JAX package; entry points (the examples' ``main``
among them) called without a device raise where there is no CUDA device
instead of running on the CPU; chip_smoke.py exits non-zero without
printing a result.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))
PORT_FILES = (
    sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    + EXAMPLES
    + [ROOT / "chip_smoke.py"]
)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 10
    banned = {"jax", "jaxlib", "repro"}
    offenders = {}
    for p in PORT_FILES:
        found = sorted(set(_imported_roots(p)) & banned)
        if found:
            offenders[str(p.relative_to(ROOT))] = found
    assert offenders == {}


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from repro_torch.core.assessment import mloe_mmom
    from repro_torch.core.covariance import MaternParams, build_sigma
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.mle import MLEConfig, fit
    from repro_torch.core.prediction import cokrige, dense_factor
    from repro_torch.core.recovery import init_status
    from repro_torch.core.tlr import tlr_loglik
    from repro_torch.configs import get_arch
    from repro_torch.models import init_caches, init_model
    from repro_torch.serving.cokrige_service import CokrigeServeConfig, fit_factor
    from repro_torch.serving.engine import generate

    locs = np.random.default_rng(0).uniform(size=(8, 2))
    z = np.zeros(16)
    params = MaternParams.bivariate(device="cpu")
    cfg = get_arch("qwen3-4b").reduced()
    model = init_model(cfg, device="cpu")
    calls = [
        lambda: MaternParams.bivariate(),
        lambda: init_status(),
        lambda: build_sigma(locs, params),
        lambda: exact_loglik(locs, z, params),
        lambda: tlr_loglik(None, z, params, locs=locs, from_tiles=True, tile_size=8),
        lambda: fit_factor(locs, z, params, CokrigeServeConfig(tile_size=8)),
        lambda: dense_factor(locs, z, params),
        lambda: cokrige(locs, z, locs[:2], params),
        lambda: dist_exact_loglik(np.zeros((8, 8)), z, params, panel=8),
        lambda: dist_tlr_loglik(
            None, z, locs=locs, params=params, from_tiles=True, tile_size=8
        ),
        lambda: mloe_mmom(locs, locs[:2], params, params),
        lambda: fit(locs, z, MLEConfig(max_iters=1)),
        lambda: init_model(cfg),
        lambda: init_caches(cfg, 1, 8),
        lambda: generate(model, cfg, np.zeros((1, 4), np.int64), 2),
    ]
    for path in EXAMPLES:
        spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        calls.append(lambda main=example.main: main([]))
    assert len(calls) == 20  # 15 entry points and 5 examples
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    _no_cuda()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True,
        text=True,
        timeout=120,
        env=env,
        cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
