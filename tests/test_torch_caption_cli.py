"""The port's caption CLI (captionax_torch/cli/caption.py) on the CPU.

First tests/test_cli_smoke.py's caption behaviours on the port, with its
TINY flags plus ``--device cpu``: per-style JSONL (one row per image and
style), greedy, and ``--requests`` (mixed styles in one stream, rows in
request order).

Then the port's JSONL against captionax's ``caption.main`` on the same
files: captionax's checkpoint is written by captionax, the port's holds the
same params carried by ``from_jax_params``, and both read one
``--encoder-weights`` state dict in torchvision's layout (ResNet-50, BN
statistics drawn from a seed).  Six images of mixed sizes (JPEG, PNG, gray
PNG) in batches of 4, so the last batch is padded.  Random decoder weights
give degenerate captions, so the weights are shaped to make the decode
depend on the image: for the beam, fc x10 and +1.0 on ``</s>`` (the beams
of two of the three styles complete, and their scores move with the
features); for greedy, the
feature MLP and init_h x10 as well (the greedy captions differ between
images).  Every row must have the same tokens, and beam scores must agree
within SCORE_TOL = 1e-3, as tests/test_torch_service.py holds the service.
The two encoders round to bf16 at other points (captionax after each
conv, the port's K4 route once per conv), which moves the scores by up to
4.4e-4 here."""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from captionax.cli import caption as ccap
from captionax.cli import common as ccommon
from captionax.train.checkpoint import save_checkpoint as jsave
from captionax_torch.cli import caption as tcap
from captionax_torch.data import native_image
from captionax_torch.interop import from_jax_params
from captionax_torch.train.checkpoint import save_checkpoint as tsave
from tests.fixtures.gru_fixture import CAPTIONS

torch.set_num_threads(1)
SCORE_TOL = 1e-3
TINY = [
    "--synthetic", "--synthetic-images", "8", "--batch-size", "4",
    "--max-epochs", "1", "--encoder-depth", "50",
    "--embed-size", "16", "--hidden-size", "16", "--feature-size", "16",
    "--hyper-emb", "8", "--hn-m", "64",
    "--max-len", "8", "--beam-max-steps", "6",
]
CPU = ["--device", "cpu"]
REQUESTS = [("im0.jpg", "humour"), ("im1.png", "factual"), ("im2.png", "romantic"),
            ("im3.jpg", "factual"), ("im4.png", "humour"), ("im0.jpg", "romantic"),
            ("im5.png", "factual")]
# (</s> bias, fc scale, feature MLP and init_h scale) of each weight set
WEIGHTS = {"beam": (1.0, 10.0, 1.0), "greedy": (1.0, 10.0, 10.0)}


def _write_images(img_dir, n, seed, mixed=True):
    img_dir.mkdir()
    rs = np.random.RandomState(seed)
    for i in range(n):
        h, w = rs.randint(40, 90, 2) if mixed else (64, 80)
        arr = rs.randint(0, 256, (h, w, 3), np.uint8)
        if not mixed or i % 3 == 0:
            Image.fromarray(arr).save(img_dir / f"im{i}.jpg", quality=90)
        else:
            Image.fromarray(arr[..., 0] if i % 3 == 2 else arr).save(img_dir / f"im{i}.png")


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------ tests/test_cli_smoke.py's
def test_caption_jsonl(tmp_path, monkeypatch):
    _write_images(tmp_path / "imgs", 5, 0, mixed=False)
    batches = []
    load = native_image.load_paths_batch
    monkeypatch.setattr(native_image, "load_paths_batch",
                        lambda paths, *a, **k: batches.append(len(paths)) or load(paths, *a, **k))
    out = tmp_path / "caps.jsonl"
    flags = TINY + CPU + ["--checkpoint-dir", str(tmp_path / "ckpt"), "--images",
                          str(tmp_path / "imgs"), "--out", str(out)]
    n = tcap.main(flags + ["--styles", "factual,humour"])
    lines = _read(out)
    assert n == len(lines) == 10
    assert {x["style"] for x in lines} == {"factual", "humour"}
    assert all("caption" in x and "score" in x and "completed" in x for x in lines)
    assert [x["image"] for x in lines] == [f"im{i}.jpg" for i in range(5)] * 2
    assert batches == [4, 1, 4, 1]  # native_image's batch loader, two chunks a style

    n2 = tcap.main(flags + ["--decode", "greedy"])
    lines = _read(out)
    assert n2 == len(lines) == 5
    assert all(set(x) == {"image", "style", "caption"} for x in lines)


def test_caption_mixed_style_requests(tmp_path):
    _write_images(tmp_path / "imgs", 5, 1, mixed=False)
    want = [("im0.jpg", "humour"), ("im1.jpg", "factual"), ("im2.jpg", "romantic"),
            ("im3.jpg", "factual"), ("im4.jpg", "humour"), ("im0.jpg", "romantic")]
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps({"image": n, "style": s}) for n, s in want))
    out = tmp_path / "caps.jsonl"
    n = tcap.main(TINY + CPU + ["--checkpoint-dir", str(tmp_path / "ckpt"), "--images",
                                str(tmp_path / "imgs"), "--requests", str(reqs), "--out",
                                str(out)])
    lines = _read(out)
    assert n == len(lines) == len(want)
    assert [(x["image"], x["style"]) for x in lines] == want
    assert all("caption" in x and "score" in x for x in lines)


@pytest.mark.parametrize("case", ("no_images", "requests_gru", "mesh_data"))
def test_refusals(tmp_path, case):
    (tmp_path / "empty").mkdir()
    _write_images(tmp_path / "imgs", 1, 2, mixed=False)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"image": "im0.jpg", "style": "factual"}))
    flags = TINY + CPU + ["--checkpoint-dir", str(tmp_path / "ckpt"), "--out",
                          str(tmp_path / "o.jsonl")]
    extra, exc, match = {
        "no_images": (["--images", str(tmp_path / "empty")], SystemExit, "no images"),
        "requests_gru": (["--images", str(tmp_path / "imgs"), "--kind", "gru", "--requests",
                          str(reqs)], SystemExit, "--kind hypernet"),
        "mesh_data": (["--images", str(tmp_path / "imgs"), "--mesh-data", "2"],
                      NotImplementedError, "Parallelism"),
    }[case]
    with pytest.raises(exc, match=match):
        tcap.main(flags + extra)


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _write_images(tmp_path / "imgs", 1, 3, mixed=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcap.main(TINY + ["--checkpoint-dir", str(tmp_path), "--images", str(tmp_path / "imgs")])


# ------------------------------------------------------ against captionax
def _state_dict(seed):
    """A torchvision-layout ResNet-50 state dict: He-normal convs, BN
    statistics drawn from a seed (the bn3 scales small, so 16 residual
    blocks stay finite)."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        w = rs.randn(cout, cin, k, k) * np.sqrt(2.0 / (k * k * cout))
        sd[name + ".weight"] = torch.from_numpy(w.astype(np.float32))

    def bn(name, c, lo=0.5, hi=1.5):
        for key, v in (("weight", rs.uniform(lo, hi, c)), ("bias", rs.normal(0, 0.1, c)),
                       ("running_mean", rs.normal(0, 0.1, c)),
                       ("running_var", rs.uniform(0.5, 1.5, c))):
            sd[f"{name}.{key}"] = torch.from_numpy(v.astype(np.float32))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            conv(p + ".conv1", width, cin, 1)
            bn(p + ".bn1", width)
            conv(p + ".conv2", width, width, 3)
            bn(p + ".bn2", width)
            conv(p + ".conv3", width * 4, width, 1)
            bn(p + ".bn3", width * 4, 0.1, 0.2)
            if b == 0:
                conv(p + ".downsample.0", width * 4, cin, 1)
                bn(p + ".downsample.1", width * 4)
            cin = width * 4
    return sd


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Images, a request file, the encoder weights and, per weight set,
    captionax's checkpoint and the port's of the same params."""
    root = tmp_path_factory.mktemp("caption_corpus")
    _write_images(root / "imgs", 6, 4)
    (root / "reqs.jsonl").write_text("\n".join(json.dumps({"image": n, "style": s})
                                               for n, s in REQUESTS))
    torch.save(_state_dict(5), root / "encoder.pt")
    flags = [a for a in TINY if a != "--synthetic"] + [
        "--factual-captions", CAPTIONS, "--vocab-path", str(root / "no_such_vocab.pkl")]
    model_cfg, _, data_cfg = ccommon.parse_configs(ccommon.make_parser("corpus").parse_args(flags))
    flags += ["--images", str(root / "imgs"), "--encoder-weights", str(root / "encoder.pt")]
    vocab = ccommon.resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    base = jax.tree_util.tree_map(
        np.asarray, ccommon.build_hypernet_model(model_cfg, vocab, jax.random.PRNGKey(0)))
    for name, (bias, fc_scale, feat_scale) in WEIGHTS.items():
        params = jax.tree_util.tree_map(np.copy, base)
        dec = params["decoder"]
        dec["fc"]["w"] = dec["fc"]["w"] * fc_scale
        dec["fc"]["b"][2] += bias
        dec["feature_fc"]["l0"]["w"] = dec["feature_fc"]["l0"]["w"] * feat_scale
        dec["init_h"]["w"] = dec["init_h"]["w"] * feat_scale
        jsave(str(root / f"jax_{name}"), 1, params)
        tsave(str(root / f"port_{name}"), 1, from_jax_params(params, device="cpu"))
    return root, flags


CASES = {
    "beam_styles": ("beam", ["--styles", "factual,humour,romantic"]),
    "greedy": ("greedy", ["--decode", "greedy", "--styles", "factual,romantic"]),
    "beam_requests": ("beam", ["--requests", "reqs.jsonl"]),
    "greedy_requests": ("greedy", ["--decode", "greedy", "--requests", "reqs.jsonl"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jsonl_matches_captionax(corpus, case):
    root, flags = corpus
    weights, extra = CASES[case]
    extra = [str(root / a) if a == "reqs.jsonl" else a for a in extra]
    ref_out, port_out = root / f"{case}_jax.jsonl", root / f"{case}_port.jsonl"
    n_ref = ccap.main(flags + extra + ["--checkpoint-dir", str(root / f"jax_{weights}"),
                                       "--out", str(ref_out)])
    n = tcap.main(flags + extra + CPU + ["--checkpoint-dir", str(root / f"port_{weights}"),
                                         "--out", str(port_out)])
    ref, got = _read(ref_out), _read(port_out)
    assert n == n_ref == len(got) == len(ref)
    assert n == (len(REQUESTS) if "requests" in case else 6 * len(extra[-1].split(",")))
    for r, g in zip(ref, got):
        assert (g["image"], g["style"], g["caption"]) == (r["image"], r["style"], r["caption"])
        assert set(g) == set(r)
        if weights == "beam":
            assert g["completed"] == r["completed"]
            assert abs(g["score"] - r["score"]) <= SCORE_TOL, (g, r)
    if weights == "beam":  # beams complete, and the features move their scores
        done = [r for r in ref if r["completed"]]
        assert len({round(r["score"], 4) for r in done}) > len({r["style"] for r in done}) > 0
    else:  # and the greedy captions
        assert len({(r["style"], r["caption"]) for r in ref}) > len({r["style"] for r in ref})


@pytest.mark.parametrize("decode", ("beam", "greedy"))
def test_fused_bank_route_picks_each_rows_style(corpus, decode):
    """--requests on the card's route: the K1 / K2 decoders over the theta
    bank with style rows (their plain versions on the CPU).  Each row must
    equal that row of the same decoder run on its style's theta alone."""
    from captionax_torch.train.checkpoint import restore_checkpoint
    from captionax_torch.train.steps import style_table, synthesize_theta_batched

    root, _ = corpus
    params = restore_checkpoint(str(root / f"port_{decode}"))
    bank = synthesize_theta_batched(params, style_table(params)[torch.tensor([4, 5, 6])])
    rows = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    feats = torch.from_numpy(np.random.RandomState(6).rand(4, 49, 2048).astype(np.float32))
    got = tcap._decode_fn(params["decoder"], bank, decode, 6, True, "cpu")(feats, rows).numpy()
    for s in range(3):
        theta = {k: v[s] for k, v in bank.items()}
        alone = tcap._decode_fn(params["decoder"], theta, decode, 6, True, "cpu")(feats).numpy()
        mine = (rows == s).numpy()
        np.testing.assert_array_equal(got[mine], alone[mine])
    assert len({got[i].tobytes() for i in range(4)}) > 1
