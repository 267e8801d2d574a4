"""The port's eval harnesses against the JAX package's on the CPU: the
ImageFolder, samplers and DataLoader contracts on a folder of PNGs,
``evaluate_reconstruction`` on a tiny VTP (the same weights, the same
seeded LPIPS state dict through both converters, the ref/rec PNG dumps and
the rFID plumbing), the BPE tokenizer on a synthetic merges file, and the
zero-shot classifier, top-k counts and eval.

Tolerances: the reconstruction eval in fp32 (exact encode and decode in
both): PSNR within 1e-3 dB, SSIM within 1e-5 abs, LPIPS within 1e-4 rel,
the Frechet moments within 1e-4 of their largest entry, saved PNGs
equal (ref) or within one level (rec); token ids equal exactly; the
zero-shot classifier within 5e-4 abs in fp32 and 5e-2 of max|ref| in
bf16; top-k counts and accuracies equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vtp_tpu.config import VTPConfig as JaxConfig
from vtp_tpu.convert.to_torch import export_state_dict
from vtp_tpu.data import DataLoader as JaxDataLoader
from vtp_tpu.data import ImageFolder as JaxImageFolder
from vtp_tpu.data import InfiniteSampler as JaxInfiniteSampler
from vtp_tpu.data import ShardedSampler as JaxShardedSampler
from vtp_tpu.eval import reconstruction as jax_rec
from vtp_tpu.eval import zero_shot as jax_zs
from vtp_tpu.metrics.lpips import LPIPS as JaxLPIPS
from vtp_tpu.models.vtp_model import VTPModel as JaxModel
from vtp_tpu.tokenizers.bpe import SimpleTokenizer as JaxTokenizer
from vtp_tpu.utils import image as jax_image
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.data import DataLoader, ImageFolder, InfiniteSampler, ShardedSampler
from vtp_tpu_torch.eval import reconstruction as rec
from vtp_tpu_torch.eval import zero_shot as zs
from vtp_tpu_torch.metrics import lpips
from vtp_tpu_torch.tokenizers import bpe
from vtp_tpu_torch.utils import image

torch.set_num_threads(1)
TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
            vision_num_heads=1, vision_feature_bottleneck=16, decoder_embed_dim=64,
            decoder_depth=2, decoder_num_heads=1, text_embed_dim=64, text_depth=2,
            text_num_heads=1, text_vocab_size=4096, text_context_length=16)


def _write_pngs(root, seed=0):
    rng = np.random.default_rng(seed)
    for cls, n in (("b_cls", 3), ("a_cls", 2)):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(n):
            arr = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, cls, f"img_{i}.png"))
    with open(os.path.join(root, "a_cls", "notes.txt"), "w") as f:
        f.write("not an image")


def _to_array(img):
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


# ----------------------------------------------------------------- data


def test_image_folder_matches_jax(tmp_path):
    _write_pngs(tmp_path)
    port, ref = ImageFolder(str(tmp_path), _to_array), JaxImageFolder(str(tmp_path), _to_array)
    assert port.classes == ref.classes == ["a_cls", "b_cls"]
    assert port.class_to_idx == ref.class_to_idx and port.samples == ref.samples
    assert len(port) == len(ref) == 5
    for i in range(len(port)):
        (x, y), (xr, yr) = port[i], ref[i]
        assert y == yr and np.array_equal(x, xr)
    flat = tmp_path / "b_cls"
    assert ImageFolder(str(flat)).samples == JaxImageFolder(str(flat)).samples


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_samplers_match_jax(shuffle, drop_last):
    for shard in range(3):
        kw = dict(n=10, shard=shard, num_shards=3, shuffle=shuffle, seed=4, drop_last=drop_last)
        for epoch in (0, 1):
            assert np.array_equal(ShardedSampler(**kw).indices(epoch),
                                  JaxShardedSampler(**kw).indices(epoch))
    port, ref = iter(InfiniteSampler(7, 1, 2, seed=3)), iter(JaxInfiniteSampler(7, 1, 2, seed=3))
    assert [next(port) for _ in range(20)] == [next(ref) for _ in range(20)]


@pytest.mark.parametrize("drop_last", [False, True])
def test_data_loader_matches_jax(tmp_path, drop_last):
    _write_pngs(tmp_path, seed=1)
    kw = dict(sampler=[4, 0, 3, 1, 2], num_workers=2, prefetch=1, drop_last=drop_last)
    port = DataLoader(ImageFolder(str(tmp_path), _to_array), 2, **kw)
    ref = JaxDataLoader(JaxImageFolder(str(tmp_path), _to_array), 2, **kw)
    got, want = list(port), list(ref)
    assert len(port) == len(ref) == len(got) == len(want)
    for (x, y), (xr, yr) in zip(got, want):
        assert np.array_equal(x, xr) and np.array_equal(y, yr)


def test_data_loader_raises_a_dataset_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 3:
                raise OSError("unreadable image 3")
            return np.zeros(2, np.float32), i

    with pytest.raises(OSError, match="unreadable image 3"):
        list(DataLoader(Broken(), 2, num_workers=2))


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (300, 420, 3), dtype=np.uint8)).save(tmp_path / "x.png")
    img = Image.open(tmp_path / "x.png").convert("RGB")
    assert np.array_equal(np.asarray(image.center_crop_arr(img, 64)),
                          np.asarray(jax_image.center_crop_arr(img, 64)))
    assert np.array_equal(np.asarray(image.resize_naive(img, 48)),
                          np.asarray(jax_image.resize_naive(img, 48)))
    got = image.load_image_for_reconstruction(str(tmp_path / "x.png"), 64)
    want = jax_image.load_image_for_reconstruction(str(tmp_path / "x.png"), 64)
    np.testing.assert_allclose(got, want, atol=1e-6)
    back = image.denormalize_nchw(torch.from_numpy(got))
    np.testing.assert_allclose(back.numpy(), jax_image.denormalize_nchw(want), atol=1e-6)
    np.testing.assert_allclose(image.normalize_nchw(back).numpy(), got, atol=1e-6)


# ------------------------------------------------------ reconstruction eval


@pytest.fixture(scope="module")
def vtp_pair():
    jc = JaxConfig(**TINY)
    jm = JaxModel.init(jax.random.key(0), jc)
    model = VTPModel(VTPConfig(**TINY), device="cpu", encode_dtype=None)
    model.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jc, jm, model


def _project(dims=2048, seed=5):
    """A cheap stand-in for the Inception features, one fixed projection of
    the pixels to ``dims``, for both packages."""
    w = np.random.default_rng(seed).standard_normal((3 * 32 * 32, dims)).astype(np.float32) / 55
    port = lambda x: torch.from_numpy(x.reshape(x.shape[0], -1).numpy() @ w)
    ref = lambda x: np.asarray(x).reshape(x.shape[0], -1) @ w
    return port, ref


def test_evaluate_reconstruction_matches_jax(vtp_pair, tmp_path, monkeypatch):
    """fp32 encode and exact decode in both, LPIPS from one seeded state dict
    saved as a torch file, rFID's moments compared (scipy's sqrtm of a
    2048-square matrix is checked in test_torch_metrics at small dims)."""
    jc, jm, model = vtp_pair
    rng = np.random.default_rng(3)
    batches = [(image.normalize_nchw(rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)),
                np.zeros(2, np.int64)) for _ in range(3)]
    torch.save({k: torch.from_numpy(v) for k, v in lpips.random_state_dict(4).items()},
               tmp_path / "lpips.pth")
    moments = {}
    monkeypatch.setattr(rec, "fid_from_stats", lambda a, b: moments.setdefault("port", (a, b)) and 1.0)
    monkeypatch.setattr(jax_rec, "fid_from_stats", lambda a, b: moments.setdefault("jax", (a, b)) and 1.0)
    port_fn, ref_fn = _project()
    got = rec.evaluate_reconstruction(
        model, batches, save_dir=str(tmp_path / "port"), max_samples=5,
        lpips_metric=lpips.LPIPS(str(tmp_path / "lpips.pth"), device="cpu"),
        inception_feature_fn=port_fn)
    want = jax_rec.evaluate_reconstruction(
        jm.params, jc, batches, compute_dtype=None, save_dir=str(tmp_path / "jax"), max_samples=5,
        lpips_metric=JaxLPIPS(str(tmp_path / "lpips.pth")), inception_feature_fn=ref_fn)
    assert got["num_samples"] == want["num_samples"] == 6  # stops after the batch reaching 5
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert abs(got["lpips"] - want["lpips"]) <= 1e-4 * abs(want["lpips"])
    assert got["rfid"] == want["rfid"] == 1.0
    for a, b in zip(moments["port"], moments["jax"]):
        assert a.count == b.count == 6
        for x, y in ((a.total, b.total), (a.outer, b.outer)):
            assert np.abs(x - y).max() <= 1e-4 * np.abs(y).max()
    for sub, tol in (("ref", 0), ("rec", 1)):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub)) and len(names) == 6
        assert rec.count_images(str(tmp_path / "port" / sub)) == 6
        for n in names:
            a = np.asarray(Image.open(tmp_path / "port" / sub / n), np.int32)
            b = np.asarray(Image.open(tmp_path / "jax" / sub / n), np.int32)
            assert np.abs(a - b).max() <= tol, (sub, n)
    moments.clear()
    port_fn, ref_fn = _project(seed=6)
    assert rec.fid_from_folders(str(tmp_path / "port" / "ref"), str(tmp_path / "port" / "rec"),
                                port_fn, batch_size=4) == 1.0
    jax_rec.fid_from_folders(str(tmp_path / "port" / "ref"), str(tmp_path / "port" / "rec"),
                             ref_fn, batch_size=4)
    for a, b in zip(moments["port"], moments["jax"]):
        assert np.abs(a.total - b.total).max() <= 1e-4 * np.abs(b.total).max()


def test_evaluate_reconstruction_without_metric_weights(vtp_pair, monkeypatch):
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    _, _, model = vtp_pair
    x = image.normalize_nchw(np.random.default_rng(4).uniform(0, 1, (2, 3, 32, 32)).astype(np.float32))
    res = rec.evaluate_reconstruction(model, [(x, np.zeros(2))])
    assert res["lpips"] is None and res["rfid"] is None and res["num_samples"] == 2
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])


# ------------------------------------------------------------ tokenizer

STRINGS = ["A photo of a Tench.", "Café naïve résumé à la crème", "東京タワーと富士山の写真",
           "digits 0123456789 and 1,234.5", "½ ² Ⅻ ⅷ ³⁄₄ ٣", "emoji 😀👍🏽 🇫🇷",
           "it's we're they've I'm you'll he'd DON'T", "punctuation!!! ... --- ??? (x) [y] {z}",
           "tabs\tand\nnewlines  and   spaces", "&amp; &lt;tag&gt; html"]


@pytest.fixture(scope="module")
def merges_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    texts = STRINGS[:5] + [t.format(c) for c in zs.load_imagenet_classnames()[:50]
                           for t in zs.load_openai_templates()[:4]]
    assert bpe.write_merges_file(path, texts) > 100
    return path


def test_tokenizer_ids_equal_jax(merges_path):
    """Latin, accented, CJK, digits, Unicode numbers (No and Nl), emoji,
    apostrophes and punctuation, seen and unseen by the merges: the same
    ids, the same context cut with EOT forced at its end."""
    port, ref = bpe.SimpleTokenizer(merges_path), JaxTokenizer(merges_path)
    assert port.vocab_size == ref.vocab_size and port.encoder == ref.encoder
    for s in STRINGS:
        assert port.encode(s) == ref.encode(s), s
        assert port.decode(port.encode(s)) == ref.decode(ref.encode(s))
    np.testing.assert_array_equal(port(STRINGS), ref(STRINGS))
    np.testing.assert_array_equal(port(STRINGS, context_length=8), ref(STRINGS, context_length=8))
    assert port(STRINGS).dtype == np.int32
    assert port.sot_token_id == ref.sot_token_id and port.eot_token_id == ref.eot_token_id


def test_tokenizer_vocab_lookup(merges_path, monkeypatch, tmp_path):
    monkeypatch.setenv(bpe.VOCAB_ENV, merges_path)
    assert bpe.find_bpe_vocab() == merges_path
    tok = bpe.get_tokenizer(context_length=16)
    assert tok.context_length == 16 and tok(["a photo"]).shape == (1, 16)
    monkeypatch.setenv(bpe.VOCAB_ENV, str(tmp_path / "missing.gz"))
    if not os.path.exists(os.path.join(os.path.dirname(bpe.__file__), bpe.VOCAB_NAME)):
        with pytest.raises(FileNotFoundError):
            bpe.find_bpe_vocab()


# ------------------------------------------------------------- zero-shot


@pytest.fixture(scope="module")
def clip_pair():
    jc = JaxConfig(**TINY)
    jm = JaxModel.init(jax.random.key(1), jc)
    model = VTPModel(VTPConfig(**TINY), device="cpu")
    model.load_numpy_state_dict(export_state_dict(jm.params, jc))
    return jc, jm, model


def test_classnames_and_templates_are_the_port_s_own_copies():
    assert zs.load_imagenet_classnames() == jax_zs.load_imagenet_classnames()
    assert zs.load_openai_templates() == jax_zs.load_openai_templates()
    assert len(zs.load_imagenet_classnames()) == 1000 and len(zs.load_openai_templates()) == 80
    assert "vtp_tpu_torch" in zs._DATA_DIR and os.path.isdir(zs._DATA_DIR)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_zero_shot_classifier_matches_jax(clip_pair, merges_path, tmp_path, monkeypatch, dtype):
    monkeypatch.setenv(zs.CACHE_ENV, str(tmp_path))
    jc, jm, model = clip_pair
    classnames, templates = zs.load_imagenet_classnames()[:13], zs.load_openai_templates()[:3]
    cdt = {"fp32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got = zs.build_zero_shot_classifier(model, bpe.SimpleTokenizer(merges_path), classnames,
                                        templates, num_classes_per_batch=5, compute_dtype=cdt[0])
    want = jax_zs.build_zero_shot_classifier(jm.params, jc, JaxTokenizer(merges_path), classnames,
                                             templates, num_classes_per_batch=5,
                                             compute_dtype=cdt[1])
    assert tuple(got.shape) == tuple(want.shape) == (64, 13)
    err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
    assert err <= (5e-4 if dtype == "fp32" else 5e-2 * np.abs(np.asarray(want, np.float32)).max())
    # the token ids were cached under $VTP_CACHE_DIR and are read back
    cached = [f for f in os.listdir(tmp_path) if f.startswith("zeroshot_tokens_")]
    assert cached
    again = zs.tokenize_classifier_prompts(None, classnames, templates, jc.text_context_length)
    assert again.shape == (13 * 3, jc.text_context_length)


def test_topk_counts_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    targets = rng.integers(0, 10, 16)
    got = zs.topk_counts(torch.from_numpy(logits), torch.from_numpy(targets))
    want = jax_zs.topk_counts(jnp.asarray(logits), jnp.asarray(targets))
    assert [float(g) for g in got] == [float(w) for w in want]


def test_evaluate_zero_shot_matches_jax(clip_pair, merges_path, tmp_path, monkeypatch):
    monkeypatch.setenv(zs.CACHE_ENV, str(tmp_path))
    jc, jm, model = clip_pair
    classnames, templates = zs.load_imagenet_classnames()[:7], zs.load_openai_templates()[:2]
    tok = bpe.SimpleTokenizer(merges_path)
    classifier = zs.build_zero_shot_classifier(model, tok, classnames, templates,
                                               compute_dtype=None)
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((3, 3, 32, 32)).astype(np.float32), rng.integers(0, 7, 3))
               for _ in range(2)]
    got = zs.evaluate_zero_shot(model, classifier, batches, compute_dtype=None)
    want = jax_zs.evaluate_zero_shot(jm.params, jc, jnp.asarray(classifier.numpy()), batches,
                                     compute_dtype=None)
    assert got == pytest.approx(want, abs=1e-9)


# ------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, clip_pair, merges_path):
    from vtp_tpu_torch.convert import save_hf_checkpoint

    root = tmp_path_factory.mktemp("cli")
    save_hf_checkpoint(str(root / "ckpt"), clip_pair[2])
    _write_pngs(root / "val", seed=5)
    return root


def test_eval_reconstruction_cli_runs_and_resumes(cli_inputs, monkeypatch, capsys):
    from vtp_tpu_torch.tools import eval_reconstruction

    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    monkeypatch.delenv("VTP_INCEPTION_WEIGHTS", raising=False)
    args = ["--model_path", str(cli_inputs / "ckpt"), "--imagenet_val", str(cli_inputs / "val"),
            "--image_size", "32", "--batch_size", "2", "--num_workers", "2", "--device", "cpu",
            "--save_dir", str(cli_inputs / "out"), "--output", str(cli_inputs / "res.json")]
    res = eval_reconstruction.main(args)
    assert res["num_samples"] == 5 and np.isfinite(res["psnr"]) and res["lpips"] is None
    assert rec.count_images(str(cli_inputs / "out" / "rec")) == 5
    assert "LPIPS will not be calculated" in capsys.readouterr().out
    again = eval_reconstruction.main(args)  # complete folders: skipped, rFID needs Inception
    assert again == {"num_samples": 5, "rfid": None}


def test_eval_zero_shot_cli_runs(cli_inputs, merges_path, monkeypatch, tmp_path):
    from vtp_tpu_torch.tools import eval_zero_shot

    monkeypatch.setenv(bpe.VOCAB_ENV, merges_path)
    monkeypatch.setenv(zs.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(zs, "load_imagenet_classnames", lambda: ["tench", "goldfish", "shark",
                                                                 "cock", "hen", "ostrich"])
    monkeypatch.setattr(zs, "load_openai_templates", lambda: ["a photo of a {}."])
    top1, top5 = eval_zero_shot.main(
        ["--model_path", str(cli_inputs / "ckpt"), "--imagenet_val", str(cli_inputs / "val"),
         "--image_size", "32", "--batch_size", "4", "--num_workers", "2", "--device", "cpu"])
    assert 0 <= top1 <= top5 <= 100


def test_compute_fid_batches(tmp_path):
    from vtp_tpu_torch.tools.compute_fid import iter_batches

    arr = np.random.default_rng(8).integers(0, 256, (5, 20, 20, 3), dtype=np.uint8)
    np.savez(tmp_path / "ref.npz", arr)
    got = np.concatenate(list(iter_batches(str(tmp_path / "ref.npz"), 2, 20)))
    np.testing.assert_array_equal(got, arr.transpose(0, 3, 1, 2).astype(np.float32) / 255.0)
    _write_pngs(tmp_path / "imgs")
    batches = list(iter_batches(str(tmp_path / "imgs"), 2, 16, num_workers=1))
    assert sum(b.shape[0] for b in batches) == 5 and batches[0].shape[1:] == (3, 16, 16)
