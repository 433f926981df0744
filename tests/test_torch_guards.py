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


def _entry_caption_service():
    from captionax_torch.decode.service import CaptionService

    CaptionService({}, {}, None)


def _entry_caption_service_int8():
    from captionax_torch.decode.service import CaptionService

    CaptionService({}, {}, None, int8_encoder=True)


def _entry_build_service():
    from captionax_torch.cli.serve import build_service, make_serve_parser

    build_service(make_serve_parser().parse_args(["--encoder-depth", "50"]))


def _entry_caption_main():
    from captionax_torch.cli.caption import main

    main(["--images", str(ROOT / "tests" / "fixtures" / "images"), "--encoder-depth", "50"])


def _entry_cnn_encoder():
    from captionax_torch.models.encoder import CNNEncoder

    CNNEncoder({})


def _entry_resnet_init():
    from captionax_torch.models.encoder import resnet_init

    resnet_init(torch.Generator().manual_seed(0), 50)


def _entry_from_torch_state_dict():
    from captionax_torch.models.encoder import from_torch_state_dict

    from_torch_state_dict({}, 50)


def _entry_preprocess_images():
    from captionax_torch.data.transforms import preprocess_images

    preprocess_images(np.zeros((1, 4, 4, 3), np.uint8))


def _entry_from_optax_state():
    from types import SimpleNamespace as NS

    from captionax_torch.interop import from_optax_state

    adam = NS(count=0, mu={"w": np.zeros(2, np.float32)}, nu={"w": np.zeros(2, np.float32)})
    finite = NS(notfinite_count=0, total_notfinite=0, inner_state=((), (adam, ())))
    from_optax_state(NS(hyperparams={"learning_rate": 1e-3}, inner_state=finite))


def _cc_cli(module: str, *extra):
    """A CC CLI's main at the fixture's flags, without --device."""
    import importlib

    from tests.fixtures.gru_fixture import flags

    importlib.import_module(f"captionax_torch.cli.{module}").main(
        flags("unused") + ["--cc-captions", str(ROOT / "no_such_cc.txt"), *extra])


def _entry_cc_train_hypernet():
    _cc_cli("cc_train_hypernet")


def _entry_test_zero_shot():
    _cc_cli("test_zero_shot")


def _entry_cc_train_gru():
    _cc_cli("cc_train_gru")


def _entry_train_cc():
    _cc_cli("train_cc", "--gcc-tsv", str(ROOT / "no_such.tsv"))


def _entry_train_hyper_combine():
    _cc_cli("train_hyper_combine")


def _entry_test_all():
    _cc_cli("test_all")


def _entry_train_init():
    _cc_cli("train_init")


def _entry_domain_embedder_init_params():
    from captionax_torch.data.domains import DomainEmbedder

    DomainEmbedder("embedding", None, ["a", "b"]).init_params(torch.Generator())


def _transformer_cli(module: str, *extra):
    """A transformer CLI's main at the fixture's flags, without --device."""
    import importlib

    from tests.fixtures.gru_fixture import flags

    importlib.import_module(f"captionax_torch.cli.{module}").main(
        flags("unused") + ["--hidden", "32", *extra])


def _entry_train_labert():
    _transformer_cli("train_labert", "--bert-layers", "1")


def _entry_train_catr():
    _transformer_cli("train_catr", "--enc-layers", "1", "--dec-layers", "1")


def _entry_labert_init():
    from captionax_torch.models.labert import labert_init

    labert_init(torch.Generator(), 10, hidden=8, num_layers=1, num_heads=1, intermediate=8,
                image_dim=8)


def _entry_catr_init():
    from captionax_torch.models.catr import catr_init

    catr_init(torch.Generator(), 10, hidden=8, num_heads=1, ff=8, enc_layers=1, dec_layers=1,
              image_dim=8)


def _entry_causal_mask():
    from captionax_torch.models.transformer import causal_mask

    causal_mask(3)


def _entry_sine_position_2d():
    from captionax_torch.models.transformer import sine_position_2d

    sine_position_2d(2, 2, 8)


def _entry_make_mesh():
    from captionax_torch.parallel import make_mesh

    make_mesh(n_data=2)


def _entry_launch():
    from captionax_torch.parallel.launch import launch

    launch(print, 2)


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


# modules whose wrappers route CPU tensors to a plain version
PLAIN_ROUTED = ("ops/decode_kernel.py", "ops/train_kernel.py", "ops/conv_kernel.py",
                "models/encoder.py", "decode/service.py")


def _cpu_test(node) -> bool:
    """``if <tensor>.device.type == "cpu":``"""
    t = node.test
    return (isinstance(t, ast.Compare) and isinstance(t.ops[0], ast.Eq)
            and isinstance(t.left, ast.Attribute) and t.left.attr == "type"
            and isinstance(t.left.value, ast.Attribute) and t.left.value.attr == "device"
            and isinstance(t.comparators[0], ast.Constant) and t.comparators[0].value == "cpu")


@pytest.mark.parametrize("rel", PLAIN_ROUTED)
def test_plain_versions_only_for_cpu_tensors(rel):
    """Outside the plain versions themselves, a ``*_plain`` function is
    called only under ``if <tensor>.device.type == "cpu":``: a CUDA tensor
    launches the kernel or raises, and never falls back."""
    bad = []

    def visit(node, func, guarded):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func, guarded = node.name, False
        if isinstance(node, ast.If) and _cpu_test(node):
            for child in node.body:
                visit(child, func, True)
            for child in node.orelse:
                visit(child, func, guarded)
            return
        if isinstance(node, ast.Call):
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            if name.endswith("_plain") and not (func or "").endswith("plain") and not guarded:
                bad.append(f"{func} calls {name} (line {node.lineno})")
        for child in ast.iter_child_nodes(node):
            visit(child, func, guarded)

    visit(ast.parse((PORT / rel).read_text()), None, False)
    assert not bad, bad


@pytest.mark.cuda
def test_fused_stage_raises_without_the_library(monkeypatch):
    """On a CUDA tensor, K4's wrapper raises when its library cannot be
    built; it does not run the plain version instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check is on a CUDA tensor, and K4 has no CPU mode")
    from captionax_torch.models.encoder import resnet_init
    from captionax_torch.ops import _cuda
    from captionax_torch.ops import conv_kernel as ck

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda, "_LIB", None)
    monkeypatch.setattr(_cuda, "build", no_nvcc)
    blocks = resnet_init(torch.Generator().manual_seed(0), 50, device="cuda")["stages"][3][1:2]
    before = [op.launches for op in ck.KERNELS]
    with pytest.raises(RuntimeError, match="nvcc"):
        ck.fused_stage(torch.ones((1, 2, 2, 2048), device="cuda"), ck.pack_stage(blocks))
    assert [op.launches for op in ck.KERNELS] == before


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
