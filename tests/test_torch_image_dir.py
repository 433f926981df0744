"""The training CLIs on a real image directory (``--img-dir``, no
``--synthetic``) on the CPU: ``resolve_flickr_data`` reads the files
through ``data/native_image.make_file_loader``, and its batches' images
equal captionax's ``FlickrStyleData`` batches over the same files (the
same native decode and resize on both sides); then ``train_hypernet`` runs
one epoch on them and ``evaluate`` tests its checkpoint."""

import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from captionax.cli import common as ccommon
from captionax_torch.cli import common as tcommon
from captionax_torch.cli import evaluate, train_hypernet
from captionax_torch.data import native_image
from tests.fixtures.gru_fixture import CAPTIONS

torch.set_num_threads(1)
N_IMAGES = 12  # tests/fixtures/captions.txt names img0.jpg .. img11.jpg, five captions each
SIZES = [
    "--batch-size", "4", "--encoder-depth", "50", "--embed-size", "16", "--hidden-size", "16",
    "--feature-size", "16", "--hyper-emb", "8", "--hn-m", "64", "--max-len", "10",
    "--beam-max-steps", "8",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The fixture's twelve images written as JPEG files of mixed sizes (two
    gray), humour and romantic caption files, and the data flags."""
    root = tmp_path_factory.mktemp("image_dir")
    img_dir = root / "images"
    img_dir.mkdir()
    rs = np.random.RandomState(9)
    for i in range(N_IMAGES):
        h, w = rs.randint(48, 120, 2)
        arr = rs.randint(0, 256, (h, w, 3), np.uint8)
        Image.fromarray(arr[..., 1] if i % 5 == 4 else arr).save(img_dir / f"img{i}.jpg",
                                                                 quality=90)
    words = "a dog runs in the grass happily chasing his dreams toward a loving home".split()
    for name in ("funny.txt", "romantic.txt"):
        (root / name).write_text("\n".join(" ".join(rs.choice(words, 6))
                                           for _ in range(N_IMAGES)) + "\n")
    flags = SIZES + ["--img-dir", str(img_dir), "--factual-captions", CAPTIONS,
                     "--humour-captions", str(root / "funny.txt"),
                     "--romantic-captions", str(root / "romantic.txt"),
                     "--vocab-path", str(root / "no_such_vocab.pkl")]
    return root, flags


def _data(common, flags):
    _, train_cfg, data_cfg = common.parse_configs(common.make_parser("data").parse_args(flags))
    vocab = common.resolve_vocab(data_cfg)
    return common.resolve_flickr_data(data_cfg, vocab, train_cfg.max_len), train_cfg


@pytest.mark.parametrize("split", (0, 1, 2), ids=("train", "val", "test"))
def test_batches_equal_captionax(corpus, split):
    _, flags = corpus
    port, cfg = _data(tcommon, flags)
    ref, _ = _data(ccommon, flags)
    assert len(port) == len(ref) == N_IMAGES and port.image_loader is not None
    idx = port.splits(seed=cfg.seed)[split]
    assert idx == ref.splits(seed=cfg.seed)[split]
    n = 0
    for style in ("factual", "humour", "romantic"):
        for a, b in zip(port.batches(idx, 4, style=style, seed=3, drop_remainder=False),
                        ref.batches(idx, 4, style=style, seed=3, drop_remainder=False)):
            assert a["images"].dtype == np.uint8 and a["images"].shape[1:] == (224, 224, 3)
            np.testing.assert_array_equal(a["images"], np.asarray(b["images"]))
            np.testing.assert_array_equal(a["captions"], np.asarray(b["captions"]))
            np.testing.assert_array_equal(a["indices"], np.asarray(b["indices"]))
            n += 1
    assert n == 3 * math.ceil(len(idx) / 4)


def test_file_loader_reads_the_directory(corpus):
    root, flags = corpus
    data, _ = _data(tcommon, flags)
    want = native_image.decode_resize((root / "images" / "img3.jpg").read_bytes())
    np.testing.assert_array_equal(data.image(3), want)


def test_train_hypernet_then_evaluate(corpus, tmp_path):
    _, flags = corpus
    d = str(tmp_path / "ckpt")
    cli = flags + ["--device", "cpu", "--checkpoint-dir", d]
    hist = train_hypernet.main(cli + ["--max-epochs", "1"])
    assert all(math.isfinite(float(v)) for v in hist[0].values())
    assert os.listdir(d)
    results = evaluate.main(cli + ["--kind", "hypernet", "--styles", "factual,romantic"])
    assert set(results) == {"factual", "romantic"}
    assert all(math.isfinite(float(v)) for r in results.values() for v in r.values())
