"""The port stands alone: no JAX, no module of the reference package, and no
silent CPU path."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core import DiffusionEngine, make_engine
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any import of jax now raises
    import torch
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.models import Model
    cfg = configs.reduced(configs.get_config("dream-7b"))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = configs.GenerationConfig(gen_length=8, block_length=4,
                                   skip_stages=(configs.SkipStage(1, 0.5),))
    out = make_engine(model, gen, device="cpu").generate(torch.randint(3, 500, (1, 6)))
    assert out.shape == (1, 14) and not (out == cfg.vocab_size).any()
    leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
    assert not leaked, leaked
    print(len(names), "modules")
""")


def test_port_imports_and_runs_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_sources_name_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\.|from repro import)",
                         re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced(configs.get_config("llada-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    gen = configs.GenerationConfig(gen_length=8, block_length=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionEngine(model, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine(model, gen)


def test_engine_and_model_devices_must_agree(monkeypatch):
    model = Model(configs.reduced(configs.get_config("llada-8b")), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="differs"):
        DiffusionEngine(model, configs.GenerationConfig(gen_length=8, block_length=4),
                        device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        Model(model.cfg, device="meta")
