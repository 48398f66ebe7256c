"""The port's boundaries: it imports neither JAX nor the JAX package,
and its entry points refuse to drop to the CPU without being asked."""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models import init_lm
from repro_torch.models.quantize import quantize_model_params
from repro_torch.core.api import PTQConfig
from repro_torch.serve import Engine, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_raise_without_cuda(monkeypatch):
    cfg = get_config("phi3-mini-3.8b").reduced()
    model = init_lm(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(get_config("deepseek-moe-16b").reduced(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(model, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        quantize_model_params(model, PTQConfig(rank=4))
    with pytest.raises(RuntimeError, match="cuda"):
        convert_params({}, cfg)
