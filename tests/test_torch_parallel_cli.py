"""``train_hyper_combine --mesh-data 2 --select-sep-margin`` on the CPU
against ``--mesh-data 0``: two gloo ranks train, every rank takes the
checkpoint decision on the reduced metrics, rank 0 alone writes, and the
test decodes the selected checkpoint, which rank 0 reads and broadcasts.
The two runs' epochs, the selected checkpoint and its test metrics must
agree (the epoch losses within 2e-5 relative, as tests/test_harness.py
holds captionax's mesh run; the probe's margins and the test metrics
within 1e-6; the selected parameters within 5e-4, as
tests/test_hypernet_train.py holds captionax's mesh step, but for the
attention's score bias ``v_a/b``, whose gradient is zero but for rounding
(a constant added to every region's score leaves the softmax as it is):
Adam takes that noise for a signal and steps it by up to ~lr, so it is
held within 2 lr a step)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from captionax_torch.cli import common as tcommon
from captionax_torch.cli import train_hyper_combine as tcombine
from captionax_torch.interop import to_numpy_tree
from captionax_torch.models.classifiers import small_style_classifier_init
from captionax_torch.train import checkpoint as tckpt
from tests.fixtures.gru_fixture import CAPTIONS, flags

torch.set_num_threads(1)
EPOCH_RTOL = 2e-5          # tests/test_harness.py:431
METRIC_TOL = 1e-6
PARAM_ATOL = 5e-4          # tests/test_hypernet_train.py:400
LR = 5e-3                  # TrainConfig's
SEP = " " * 5
CC_DOMAINS = ("alamy", "dailymail", "wordpress", "pinimg")


def write_cc(path, rows=12, seed=1):
    rs = np.random.RandomState(seed)
    with open(CAPTIONS) as f:
        words = sorted({w for line in f for w in line.split("\t", 1)[1].split()
                        if w.isalpha()})
    with open(path, "w") as f:
        for dom in CC_DOMAINS:
            for i in range(rows):
                f.write(f"{dom}_{i}.jpg{SEP}{' '.join(rs.choice(words, rs.randint(4, 9)))}"
                        f"{SEP}{dom}\n")
    return str(path)


def read_log(directory):
    with open(os.path.join(directory, "run.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs, two epochs each, from the same seed; -> {n: (history,
    checkpoint dir)}."""
    tmp = tmp_path_factory.mktemp("combine_mesh")
    cc = write_cc(tmp / "cc.txt")

    def argv(d):
        return flags(d) + ["--hyper-emb", "8", "--hn-m", "64", "--max-epochs", "2",
                           "--cc-captions", cc, "--domain-scheme", "one hot",
                           "--skip-val-quality", "--cache-features", "--device", "cpu"]

    vocab = tcommon.resolve_vocab(tcommon.parse_configs(
        tcommon.make_parser("").parse_args(argv("x")))[2])
    probe = str(tmp / "probe4.pkl")
    with open(probe, "wb") as f:
        pickle.dump(to_numpy_tree(small_style_classifier_init(
            torch.Generator().manual_seed(0), len(vocab), 16, 4, device="cpu")), f)
    select = ["--style-classifier", probe, "--select-sep-margin", "--sep-probe-images", "4"]
    out = {}
    for n in (0, 2):
        d = str(tmp / f"mesh{n}")
        out[n] = (tcombine.main(argv(d) + select + ["--mesh-data", str(n)]), d)
    return out


def test_epochs_agree(runs):
    (one, _), (two, _) = runs[0], runs[2]
    assert sorted(two) == sorted(one) == [0, 1]
    for epoch in one:
        for key in ("train_loss_epoch", "val_loss_tf", "val_loss"):
            np.testing.assert_allclose(two[epoch][key], one[epoch][key], rtol=EPOCH_RTOL,
                                       err_msg=f"{key} {epoch}")
        for key in ("val_sep_margin", "val_sep_acc"):
            assert abs(two[epoch][key] - one[epoch][key]) <= METRIC_TOL, (key, epoch)


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def test_one_selected_checkpoint_written_by_rank_0(runs):
    """The same epoch is selected; one checkpoint directory, its
    parameters those of the one-device run's."""
    (_, d1), (_, d2) = runs[0], runs[2]
    steps = [sorted(s for s in os.listdir(d) if s.isdigit()) for d in (d1, d2)]
    assert steps[1] == steps[0] and len(steps[1]) == 1
    got, ref = (named_leaves(tckpt.restore_checkpoint(d)) for d in (d2, d1))
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(got, ref):
        atol = 2 * LR * int(steps[0][0]) if name.endswith("v_a/b") else PARAM_ATOL
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol, err_msg=name)


def test_selected_checkpoints_test_metrics_agree(runs):
    """The test decodes the selected checkpoint on both ranks: rank 0's
    log has the one-device run's rows, and the test metrics agree."""
    logs = [read_log(runs[n][1]) for n in (0, 2)]
    assert len(logs[1]) == len(logs[0])
    tests = [{k: v for r in log for k, v in r.items() if k.startswith("test_")}
             for log in logs]
    assert tests[0] and set(tests[1]) == set(tests[0])
    for k, v in tests[0].items():
        assert abs(tests[1][k] - v) <= METRIC_TOL, (k, tests[1][k], v)
