"""Guards of the PyTorch port: it imports no JAX and nothing of captionax,
it never falls back from the card to the CPU, and chip_smoke.py refuses to
run (and never reports success) where there is no card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "captionax_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "optax", "captionax")


def _sources():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_captionax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_imports_with_jax_and_captionax_blocked(tmp_path):
    """Every module of the port and chip_smoke import with jax and captionax
    made unimportable, and importing builds no kernel."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'optax', 'captionax'):\n"
        "    sys.modules[name] = None\n"
        "import captionax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(captionax_torch.__path__, 'captionax_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from captionax_torch.ops import _cuda\n"
        "assert _cuda._LIB is None\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 10


def test_resolve_device_raises_without_cuda(monkeypatch):
    from captionax_torch.core.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_decoder():
    from captionax_torch.models.decoder import attention_gru_init

    return attention_gru_init(torch.Generator().manual_seed(0), 8, 4, 4, 4, 10, device="cpu")


def _entry_attention_gru_init():
    from captionax_torch.models.decoder import attention_gru_init

    attention_gru_init(torch.Generator().manual_seed(0), 8, 4, 4, 4, 10)


def _entry_fused_beam_search():
    from captionax_torch.ops.decode_kernel import fused_beam_search

    fused_beam_search(_tiny_decoder(), torch.zeros((2, 3, 8)), max_steps=2)


def _entry_make_beam_server():
    from captionax_torch.decode.serving import make_beam_server

    make_beam_server(_tiny_decoder(), max_steps=2)


def _entry_create_train_state():
    from captionax_torch.train.state import create_train_state, make_optimizer

    create_train_state(_tiny_decoder(), make_optimizer(1e-3))


def _entry_from_optax_state():
    from types import SimpleNamespace as NS

    from captionax_torch.interop import from_optax_state

    adam = NS(count=0, mu={"w": np.zeros(2, np.float32)}, nu={"w": np.zeros(2, np.float32)})
    finite = NS(notfinite_count=0, total_notfinite=0, inner_state=((), (adam, ())))
    from_optax_state(NS(hyperparams={"learning_rate": 1e-3}, inner_state=finite))


ENTRY_POINTS = {name[7:]: fn for name, fn in globals().items() if name.startswith("_entry_")}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_greedy_entry_points_default_to_the_card(monkeypatch):
    from captionax_torch.decode.search import greedy, sample
    from captionax_torch.decode.serving import make_greedy_server
    from captionax_torch.models.decoder import attention_gru_init
    from captionax_torch.ops.decode_kernel import fused_greedy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = attention_gru_init(torch.Generator().manual_seed(0), 8, 4, 4, 4, 10,
                                device="cpu")
    raw = torch.zeros((2, 3, 8))
    for call in (lambda: fused_greedy(params, raw, max_len=2),
                 lambda: make_greedy_server(params, max_len=2),
                 lambda: greedy(params, raw, max_len=2),
                 lambda: sample(params, raw, None, max_len=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _claims_ok(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (json.JSONDecodeError, AttributeError):
            continue
    return '"ok": true' in stdout


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert not _claims_ok(out.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert not _claims_ok(out.stdout)
