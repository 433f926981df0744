"""The port's checkpoint bridge (captionax_torch/models/convert.py,
cli/import_checkpoint.py, cli/export_checkpoint.py) on the CPU, every case
of tests/test_convert_checkpoint.py.

The reference-layout state_dicts are those of the reference modules'
attribute layouts (``RefAttentionGru``, ``RefHyperNet`` of that test),
turned into numpy arrays, or fabricated with numpy
(``fabricate_resnet_state_dict``).  The port's import equals
``from_jax_params`` of captionax's import bit for bit, and runs as the
reference modules do (teacher-forced logits, the hypernet's flat theta,
within 2e-5); the export strict-loads into the reference modules and
re-imports bit for bit; the encoder's identity-BN export folds back bit for
bit.  The CLIs: an imported checkpoint restores in the port's
``evaluate``, and a ``train_gru`` checkpoint with its encoder exported and
imported again evaluates exactly as the original does."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from captionax.models import convert as jconvert
from captionax_torch.interop import from_jax_params
from captionax_torch.models import convert
from captionax_torch.models import decoder as tdec
from captionax_torch.models.hypernet import hypernet_apply_flat
from captionax_torch.train.state import tree_leaves
from tests.test_convert_checkpoint import (
    E,
    RefAttentionGru,
    RefHyperNet,
    _batch,
)

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def numpy_sd(module: nn.Module, prefix: str = "") -> dict:
    return {prefix + k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def same_tree(a, b):
    """Equal structure (dict keys, list lengths) and bit-equal leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            same_tree(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    else:
        assert torch.is_tensor(a) and a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def carried(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def logits(params, feats, caps):
    with torch.no_grad():
        return tdec.teacher_forced(params, feats, caps)[0].numpy()


class TestAttentionGruImport:
    @pytest.mark.parametrize("num_layers", [1, 3])
    def test_teacher_forced_logits_match(self, num_layers):
        m = RefAttentionGru(num_layers=num_layers)
        sd = numpy_sd(m, "captioner.")
        params = convert.attention_gru_from_state_dict(sd, device="cpu")
        same_tree(params, carried(jconvert.attention_gru_from_state_dict(sd)))
        assert len(params.get("layers", [])) == num_layers - 1
        feats, caps = _batch()
        with torch.no_grad():
            ref = m(feats, caps).numpy()
        np.testing.assert_allclose(logits(params, feats, caps), ref, atol=2e-5)


class TestHyperNetImport:
    def theta(self, m, hn):
        style = torch.randn(E, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            return m.theta_flat(style).numpy(), hypernet_apply_flat(hn, style).numpy()

    def test_theta_matches_reference_heads(self):
        m = RefHyperNet()
        sd = numpy_sd(m)
        hn = convert.hypernet_from_state_dict(sd, device="cpu")
        same_tree(hn, carried(jconvert.hypernet_from_state_dict(sd)))
        ref, got = self.theta(m, hn)
        np.testing.assert_allclose(got, ref, atol=2e-5)

    def test_lightning_ckpt_roundtrip(self, tmp_path):
        m = RefHyperNet()
        path = tmp_path / "epoch=19.ckpt"
        torch.save({"state_dict": m.state_dict(),
                    "hyper_parameters": {"feature_size": 12, "embed_size": E,
                                         "hidden_size": 12, "lr": 2e-3}}, path)
        out = convert.load_lightning_checkpoint(str(path), device="cpu")
        assert out["kind"] == "hypernet" and out["hparams"]["hidden_size"] == 12
        assert out["encoder_state_dict"] is None
        same_tree(out["params"], carried(jconvert.load_lightning_checkpoint(str(path))["params"]))
        ref, got = self.theta(m, out["params"]["hn"])
        np.testing.assert_allclose(got, ref, atol=2e-5)

    def test_cc_nesting_and_domain_table(self):
        hn = RefHyperNet()
        outer = nn.Module()
        outer.hypernet = hn
        outer.embed = nn.Embedding(7, E)
        sd = numpy_sd(outer)
        kind, params, enc = convert.import_lightning_state_dict(sd, device="cpu")
        assert kind == "hypernet_cc" and enc is None
        same_tree(params, carried(jconvert.import_lightning_state_dict(sd)[1]))
        np.testing.assert_array_equal(params["domain_emb"]["table"].numpy(),
                                      outer.embed.weight.detach().numpy())
        feats, caps = _batch()
        with torch.no_grad():
            ref = hn.captioner(feats, caps).numpy()
        np.testing.assert_allclose(logits(params["decoder"], feats, caps), ref, atol=2e-5)

    def test_cc_histogram_embed_scheme(self):
        emb = nn.Sequential(nn.Linear(42, 4 * E), nn.LeakyReLU(), nn.Linear(4 * E, E),
                            nn.LeakyReLU())
        sd = numpy_sd(emb, "embed.")
        p = convert.domain_embedder_from_state_dict(sd, device="cpu")
        assert tuple(p["l0"]["w"].shape) == (42, 4 * E)
        assert tuple(p["l1"]["w"].shape) == (4 * E, E)
        same_tree(p, carried(jconvert.domain_embedder_from_state_dict(sd)))
        jsd = {"embed.0.weight": sd["embed.0.weight"], "embed.0.bias": sd["embed.0.bias"]}
        same_tree(convert.domain_embedder_from_state_dict(jsd, device="cpu"),
                  carried(jconvert.domain_embedder_from_state_dict(jsd)))
        assert convert.domain_embedder_from_state_dict({}, device="cpu") == {}


class TestEncoderRemap:
    def test_sequential_indices_to_torchvision_names(self):
        from tests.fixtures.converter_fixture import fabricate_resnet_state_dict

        tv = fabricate_resnet_state_dict()
        inverse = {v: k for k, v in convert._RESNET_SEQ_NAMES.items()}
        lightning = {}
        for key, val in tv.items():
            head, _, tail = key.partition(".")
            lightning[f"image_encoder.resnet.{inverse[head]}.{tail}"] = val
        remapped = convert.encoder_state_dict_from_lightning(lightning)
        assert set(remapped) == set(tv) == set(jconvert.encoder_state_dict_from_lightning(
            lightning))
        for key in tv:
            np.testing.assert_array_equal(remapped[key].numpy(), np.asarray(tv[key]))
        assert convert.trunk_to_lightning(remapped, "gru").keys() == lightning.keys()


class TestImportCLI:
    def test_cli_writes_evaluate_compatible_checkpoint(self, tmp_path):
        from captionax_torch.cli.import_checkpoint import main
        from captionax_torch.train.checkpoint import restore_checkpoint

        outer = nn.Module()  # CaptionAttentionGru nests under `captioner.`
        outer.captioner = RefAttentionGru()
        ckpt = tmp_path / "gru.ckpt"
        torch.save({"state_dict": outer.state_dict()}, ckpt)
        out_dir = tmp_path / "imported"
        imported = main(["--ckpt", str(ckpt), "--out", str(out_dir)] + CPU)
        assert imported["kind"] == "gru"
        restored = restore_checkpoint(str(out_dir))
        same_tree(restored, carried(jconvert.load_lightning_checkpoint(str(ckpt))["params"]))
        feats, caps = _batch()
        with torch.no_grad():
            ref = outer.captioner(feats, caps).numpy()
        np.testing.assert_allclose(logits(restored, feats, caps), ref, atol=2e-5)


class TestExport:
    """The export is the exact inverse of the import: the reference modules
    strict-load it and it re-imports bit for bit."""

    def test_gru_strict_load_and_bitexact_roundtrip(self):
        m = RefAttentionGru(num_layers=2)
        params = convert.attention_gru_from_state_dict(numpy_sd(m, "captioner."), device="cpu")
        sd = convert.export_lightning_state_dict("gru", params)
        m2 = RefAttentionGru(num_layers=2)
        m2.load_state_dict({k[len("captioner."):]: v for k, v in sd.items()}, strict=True)
        kind, params2, enc = convert.import_lightning_state_dict(sd, device="cpu")
        assert kind == "gru" and enc is None
        same_tree(params2, params)
        jsd = jconvert.export_lightning_state_dict("gru", jax.tree_util.tree_map(
            lambda t: t.numpy(), params))
        assert set(jsd) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(sd[k].numpy(), jsd[k])
        feats, caps = _batch()
        with torch.no_grad():
            np.testing.assert_array_equal(m(feats, caps).numpy(), m2(feats, caps).numpy())

    def test_hypernet_strict_load_and_roundtrip(self):
        m = RefHyperNet()
        kind0, params, _ = convert.import_lightning_state_dict(numpy_sd(m), device="cpu")
        assert kind0 == "hypernet"
        sd = convert.export_lightning_state_dict("hypernet", params)
        m2 = RefHyperNet()
        m2.load_state_dict(sd, strict=True)
        kind, params2, _ = convert.import_lightning_state_dict(sd, device="cpu")
        assert kind == "hypernet"
        same_tree(params2, params)
        style = torch.randn(E, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            np.testing.assert_array_equal(m.theta_flat(style).numpy(),
                                          m2.theta_flat(style).numpy())

    def test_hypernet_cc_roundtrip_with_domain_table(self):
        outer = nn.Module()
        outer.hypernet = RefHyperNet()
        outer.embed = nn.Embedding(7, E)
        kind0, params, _ = convert.import_lightning_state_dict(numpy_sd(outer), device="cpu")
        assert kind0 == "hypernet_cc"
        sd = convert.export_lightning_state_dict("hypernet_cc", params)
        kind, params2, _ = convert.import_lightning_state_dict(sd, device="cpu")
        assert kind == "hypernet_cc"
        same_tree(params2, params)
        with pytest.raises(ValueError, match="unknown kind"):
            convert.export_lightning_state_dict("lstm", params)

    def test_encoder_identity_bn_export_is_exact(self):
        from captionax_torch.models import encoder as enc_mod

        enc_p = enc_mod.resnet_init(torch.Generator().manual_seed(0), 50, device="cpu")
        sd = convert.encoder_state_dict_from_params(enc_p)
        assert sd["bn1.running_mean"].sum().item() == 0.0
        same_tree(enc_mod.from_torch_state_dict(sd, depth=50, device="cpu"), enc_p)
        back = convert.import_lightning_state_dict(
            convert.export_lightning_state_dict("gru", convert.attention_gru_from_state_dict(
                numpy_sd(RefAttentionGru(), "captioner."), device="cpu"), enc_p), "cpu")[2]
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k

    def test_export_cli_reimport_roundtrip(self, tmp_path):
        from captionax_torch.cli.export_checkpoint import main as export_main
        from captionax_torch.cli.import_checkpoint import main as import_main
        from captionax_torch.train.checkpoint import restore_checkpoint, save_checkpoint

        _, params, _ = convert.import_lightning_state_dict(numpy_sd(RefHyperNet()), "cpu")
        ckpt_dir = tmp_path / "trained"
        save_checkpoint(str(ckpt_dir), 0, params)
        out_ckpt = tmp_path / "exported.ckpt"
        export_main(["--checkpoint-dir", str(ckpt_dir), "--kind", "hypernet", "--out",
                     str(out_ckpt), "--hparams", '{"lr": 0.002}'])
        blob = torch.load(out_ckpt, map_location="cpu", weights_only=False)
        assert blob["hyper_parameters"]["lr"] == 0.002
        # captionax reads the file as the reference's Lightning checkpoint
        assert jconvert.load_lightning_checkpoint(str(out_ckpt))["kind"] == "hypernet"
        back_dir = tmp_path / "reimported"
        import_main(["--ckpt", str(out_ckpt), "--out", str(back_dir)] + CPU)
        same_tree(restore_checkpoint(str(back_dir)), params)


def test_trained_checkpoint_exports_and_evaluates_alike(tmp_path):
    """train_gru's checkpoint and its encoder (the run's seeded ResNet-50,
    as a torchvision state_dict) through export_checkpoint then
    import_checkpoint --encoder-out: the parameters and the trunk come back
    bit for bit, and evaluate on the imported checkpoint and trunk gives the
    original's beam-test metrics exactly."""
    from captionax_torch.cli import evaluate, train_gru
    from captionax_torch.cli.common import build_encoder, model_generators, parse_configs
    from captionax_torch.cli.export_checkpoint import main as export_main
    from captionax_torch.cli.import_checkpoint import main as import_main
    from captionax_torch.train.checkpoint import restore_checkpoint
    from tests.fixtures.gru_fixture import flags

    trained, back = str(tmp_path / "trained"), str(tmp_path / "back")
    train_gru.main(flags(trained) + CPU + ["--max-epochs", "1"])
    model_cfg, train_cfg, _ = parse_configs(evaluate.make_parser("").parse_args(flags(trained)))
    enc = build_encoder(model_cfg, model_generators(train_cfg.seed)[1], device="cpu")
    trunk = tmp_path / "trunk.pt"
    torch.save(convert.encoder_state_dict_from_params(enc), trunk)
    ckpt = tmp_path / "gru.ckpt"
    export_main(["--checkpoint-dir", trained, "--kind", "gru", "--out", str(ckpt),
                 "--encoder-weights", str(trunk)])
    import_main(["--ckpt", str(ckpt), "--out", back, "--encoder-out",
                 str(tmp_path / "trunk2.pt")] + CPU)
    same_tree(restore_checkpoint(back), restore_checkpoint(trained))
    trunk2 = torch.load(tmp_path / "trunk2.pt", weights_only=True)
    for k, v in torch.load(trunk, weights_only=True).items():
        assert torch.equal(trunk2[k], v), k
    want = evaluate.main(flags(trained) + CPU + ["--kind", "gru", "--styles", "factual"])
    got = evaluate.main(flags(back) + CPU + ["--kind", "gru", "--styles", "factual",
                                             "--encoder-weights", str(tmp_path / "trunk2.pt")])
    assert got == want
    assert len(tree_leaves(restore_checkpoint(back))) == len(tree_leaves(
        restore_checkpoint(trained)))
