"""The port's serve CLI (captionax_torch/cli/serve.py) on the CPU: its flag
surface against captionax's, ``build_service`` from those flags serving
over HTTP (bf16 and ``--int8-encoder``), the int8 service's calibration,
and the options that raise or exit."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from captionax.cli import serve as cserve
from captionax_torch.cli import serve as tserve
from captionax_torch.decode.service import serve_background

torch.set_num_threads(1)
TINY = [
    "--synthetic", "--synthetic-images", "8", "--batch-size", "4",
    "--max-epochs", "1", "--encoder-depth", "50",
    "--embed-size", "16", "--hidden-size", "16", "--feature-size", "16",
    "--hyper-emb", "8", "--hn-m", "64",
    "--max-len", "8", "--beam-max-steps", "6",
]


def _args(tmp_path, *extra):
    return TINY + ["--device", "cpu", "--window", "4", "--checkpoint-dir",
                   str(tmp_path / "ckpt"), *extra]


def _options(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_matches_captionax_plus_device():
    port, ref = _options(tserve.make_serve_parser()), _options(cserve.make_serve_parser())
    assert set(port) == set(ref) | {"device"}
    for dest, a in ref.items():
        b = port[dest]
        assert (b.option_strings, b.default, b.choices, b.type, b.nargs, b.required) == (
            a.option_strings, a.default, a.choices, a.type, a.nargs, a.required), dest
    assert port["device"].default is None and port["device"].option_strings == ["--device"]


def _post(port, data, style):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/caption?style={style}", data=data,
                                 headers={"Content-Type": "image/png"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _png(seed):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 256, (40, 52, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("int8", (False, True), ids=("bf16", "int8"))
def test_build_service_serves_http(tmp_path, int8):
    extra = ["--styles", "factual,humour"] + (["--int8-encoder"] if int8 else [])
    args = tserve.make_serve_parser().parse_args(_args(tmp_path, *extra))
    service = tserve.build_service(args)
    srv, port = serve_background(service)
    try:
        for style, seed in (("factual", 0), ("humour", 1)):
            status, body = _post(port, _png(seed), style)
            assert status == 200 and body["style"] == style
            assert set(body) == {"caption", "score", "completed", "style"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["styles"] == ["factual", "humour"]
        assert service.stats()["served"] == 2
        if int8:
            qparams = service.encoder.args[0]
            assert qparams["stages"][0][0]["conv2"]["q"].dtype == torch.int8
            assert all("ascale" in qp for blocks in qparams["stages"] for blk in blocks
                       for qp in blk.values())
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()


def test_int8_service_calibration(tmp_path):
    """The int8 service quantizes with 1.5x the scales of a bf16 calibration
    forward over RandomState(0)'s 8 random images (captionax's default), and
    its features stay within captionax's int8 bounds of the f32 encoder."""
    from captionax_torch.cli.common import build_encoder, model_generators, parse_configs
    from captionax_torch.data.transforms import preprocess_images
    from captionax_torch.decode.service import _int8_encoder
    from captionax_torch.models.encoder import (
        encoder_cnn,
        resnet_calibrate,
        resnet_quantize,
    )

    args = tserve.make_serve_parser().parse_args(_args(tmp_path))
    model_cfg, train_cfg, _ = parse_configs(args)
    enc = build_encoder(model_cfg, model_generators(train_cfg.seed)[1], device="cpu")
    rs = np.random.RandomState(4)
    for blocks in enc["stages"]:  # resnet_init zeroes conv3's scales: draw them
        for blk in blocks:
            blk["conv3"]["scale"] = torch.from_numpy(rs.uniform(0.1, 0.2, blk["conv3"]["scale"]
                                                                .numel()).astype(np.float32))
    calib = np.random.RandomState(0).randint(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    encode = _int8_encoder(enc, calib, 64, torch.device("cpu"))
    scales = resnet_calibrate(enc, preprocess_images(torch.from_numpy(calib)))
    want = resnet_quantize(enc, {"stages": [[{k: v * 1.5 for k, v in r.items()} for r in st]
                                            for st in scales["stages"]]})
    got = encode.args[0]
    for s, blocks in enumerate(want["stages"]):
        for b, blk in enumerate(blocks):
            for name, qp in blk.items():
                for k, v in qp.items():
                    assert torch.equal(got["stages"][s][b][name][k], v), (s, b, name, k)
    x = preprocess_images(torch.from_numpy(
        np.random.RandomState(5).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)))
    q, f32 = encode(x).numpy(), encoder_cnn(enc, x, torch.float32).numpy()
    assert np.abs(q - f32).mean() / (np.abs(f32).mean() + 1e-6) < 0.1
    assert float(q.ravel() @ f32.ravel() / (np.linalg.norm(q) * np.linalg.norm(f32))) > 0.99


def test_mesh_data_raises(tmp_path, monkeypatch):
    """--mesh-data, which raised until data parallelism was ported, now
    shards each dispatch over two CPU slots; its captions are the
    one-device service's.  The mesh leaves the decode route to the device
    (K1 / K2 on the card): only --no-fused asks for the plain decoders."""
    img = np.random.RandomState(4).randint(0, 256, (224, 224, 3), dtype=np.uint8)
    parse = tserve.make_serve_parser().parse_args
    args = parse(_args(tmp_path, "--mesh-data", "2"))
    with tserve.build_service(args) as two, tserve.build_service(parse(_args(tmp_path))) as one:
        assert two.caption_array(img, "factual") == one.caption_array(img, "factual")

    from captionax_torch.decode import service as tservice

    asked = []
    monkeypatch.setattr(tservice, "CaptionService",
                        lambda *a, **kw: asked.append((kw["mesh"].n_data, kw["use_fused"])))
    tserve.build_service(args)
    tserve.build_service(parse(_args(tmp_path, "--mesh-data", "2", "--no-fused")))
    assert asked == [(2, None), (2, False)]


def test_rss_limit_needs_a_fixed_port(tmp_path):
    argv = _args(tmp_path, "--rss-limit-mb", "100", "--port", "0")
    with pytest.raises(SystemExit, match="fixed --port"):
        tserve.main(argv)
    with pytest.raises(SystemExit, match="fixed --port"):  # captionax's, without --device
        cserve.main([a for a in argv if a not in ("--device", "cpu")])


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    args = tserve.make_serve_parser().parse_args(TINY + ["--checkpoint-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_service(args)
