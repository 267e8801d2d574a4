"""The port's generation pipeline against the JAX package on the CPU:
latent shards, their statistics, ``LatentShardDataset``,
``VTPTokenizer.from_checkpoint`` and the three CLIs
(``vtp_tpu_torch.tools.extract_latents``, ``train_dit``, ``sample_dit``).

- Shards written by either package load bit-equal in the other (fp32
  latents, I64 or I32 labels, the ``total_size``/``dtype`` metadata); the
  statistics are bit-equal to JAX's on the same shards (both stream in
  float64 numpy), and the ``.pt`` copy loads.
- The dataset's first 6 batches at 2 shards are bit-equal to JAX's for the
  same seed (the same ``default_rng`` draws in the same order), and a
  stream started with ``skip`` continues it.
- ``from_checkpoint`` on a checkpoint the port writes encodes within 5e-2
  of max|ref| of JAX ``VTPTokenizer.from_checkpoint`` (the bf16 gate).
- The CLIs run as ``python -m ... --device cpu`` on a folder of PNGs: the
  extraction's shards within the bf16 gate of the JAX CLI's on the same
  checkpoint (labels equal); training 2 steps, then ``--resume`` to 3;
  sampling with ``--cfg_scale 1.5 --save_npz``: (n, 32, 32, 3) uint8.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from vtp_tpu.dit.train import LatentShardDataset as JaxLatentShardDataset
from vtp_tpu.generation import latents as jlatents
from vtp_tpu.generation.vtp_tokenizer import VTPTokenizer as JaxTokenizer
from vtp_tpu_torch import VTPConfig, VTPModel
from vtp_tpu_torch.convert import save_hf_checkpoint
from vtp_tpu_torch.convert.safetensors_io import read_safetensors_header
from vtp_tpu_torch.dit.train import LatentShardDataset
from vtp_tpu_torch.generation import VTPTokenizer
from vtp_tpu_torch.generation import latents as tlatents

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VTP_TINY = dict(image_size=32, vision_patch_size=16, vision_embed_dim=64, vision_depth=2,
                vision_num_heads=1, vision_feature_bottleneck=16, decoder_embed_dim=64,
                decoder_num_heads=1, decoder_depth=2, train_clip=False)
ROWS, C, S = 10, 16, 2


def _shard_arrays(rng, labels_dtype=np.int64, rows=ROWS):
    lat = rng.normal(1.5, 2.0, (rows, C, S, S)).astype(np.float32)
    flip = rng.normal(1.5, 2.0, (rows, C, S, S)).astype(np.float32)
    return lat, flip, rng.integers(0, 10, rows).astype(labels_dtype)


def _write_shards(save, d, n_shards, seed=0):
    rng = np.random.default_rng(seed)
    for s in range(n_shards):
        save(str(d), 0, s, *_shard_arrays(rng))


@pytest.mark.parametrize("labels_dtype", [np.int64, np.int32])
def test_shards_load_bit_equal_across_packages(tmp_path, labels_dtype):
    arrays = _shard_arrays(np.random.default_rng(1), labels_dtype)
    names = ("latents", "latents_flip", "labels")
    want_meta = {"total_size": str(ROWS), "dtype": "float32"}
    for writer, reader in ((jlatents, tlatents), (tlatents, jlatents)):
        d = tmp_path / writer.__name__.split(".")[0]
        path = writer.save_latent_shard(str(d), 3, 7, *arrays)
        assert os.path.basename(path) == "latents_rank03_shard007.safetensors"
        (got,) = list(reader.load_latent_shards(str(d)))
        for name, want in zip(names, arrays):
            assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name
        assert read_safetensors_header(path)[1]["__metadata__"] == want_meta
        assert reader.list_latent_shards(str(d)) == [path]
    # the port's file is the package's, but for the metadata's key order
    port = read_safetensors_header(str(tmp_path / "vtp_tpu_torch" /
                                       "latents_rank03_shard007.safetensors"))[1]
    jax_ = read_safetensors_header(str(tmp_path / "vtp_tpu" /
                                       "latents_rank03_shard007.safetensors"))[1]
    assert port == jax_ and list(port)[1:] == list(jax_)[1:]


def test_latent_stats_bit_equal_to_jax(tmp_path):
    _write_shards(jlatents.save_latent_shard, tmp_path, 3)
    want = jlatents.compute_latent_stats(str(tmp_path), save=False)
    got = tlatents.compute_latent_stats(str(tmp_path))
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (1, C, 1, 1) and np.array_equal(g, w)
    for g, w in zip(jlatents.load_latent_stats(str(tmp_path)), want):
        assert np.array_equal(g, w)
    os.remove(tmp_path / tlatents.STATS_FILE)  # the LightningDiT .pt alone
    for g, w in zip(tlatents.load_latent_stats(str(tmp_path)), want):
        assert np.array_equal(g, w)
    pt = torch.load(tmp_path / tlatents.STATS_PT_FILE, weights_only=True)
    assert np.array_equal(pt["mean"].numpy(), want[0])
    with pytest.raises(FileNotFoundError):
        tlatents.load_latent_stats(str(tmp_path / "none"))


def test_dataset_batches_bit_equal_to_jax(tmp_path):
    _write_shards(tlatents.save_latent_shard, tmp_path, 2, seed=2)
    tlatents.compute_latent_stats(str(tmp_path))
    want = JaxLatentShardDataset(str(tmp_path), seed=5).batches(4)
    got = LatentShardDataset(str(tmp_path), seed=5, device="cpu").batches(4)
    batches = []
    for _ in range(6):  # two batches a shard: three epochs
        (z, y), (wz, wy) = next(got), next(want)
        assert z.dtype == torch.float32 and y.dtype == torch.int32 and wy.dtype == np.int32
        assert np.array_equal(z.numpy(), wz) and np.array_equal(y.numpy(), wy)
        batches.append((z, y))
    skipped = LatentShardDataset(str(tmp_path), seed=5, device="cpu").batches(4, skip=3)
    for z, y in batches[3:]:
        sz, sy = next(skipped)
        assert torch.equal(sz, z) and torch.equal(sy, y)
    raw = next(LatentShardDataset(str(tmp_path), latent_norm=False, seed=5,
                                  device="cpu").batches(4))[0]
    assert not torch.equal(raw, batches[0][0])
    with pytest.raises(ValueError):
        next(LatentShardDataset(str(tmp_path), seed=5, device="cpu").batches(ROWS + 1))
    with pytest.raises(FileNotFoundError):
        LatentShardDataset(str(tmp_path / "none"), device="cpu")


# ------------------------------------------------------- checkpoint and CLIs


@pytest.fixture(scope="module")
def pipeline_inputs(tmp_path_factory):
    """A tiny VTP checkpoint written by the port and a folder of 12 PNGs in
    two classes."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pipeline")
    model = VTPModel.init(VTPConfig(**VTP_TINY), torch.Generator().manual_seed(0), device="cpu")
    save_hf_checkpoint(str(root / "vtp"), model)
    rng = np.random.default_rng(0)
    for c in ("a", "b"):
        os.makedirs(root / "imgs" / c)
        for i in range(6):
            img = rng.integers(0, 255, (40, 48, 3), np.uint8)
            Image.fromarray(img).save(root / "imgs" / c / f"{i}.png")
    return root


def test_tokenizer_from_checkpoint_matches_jax(pipeline_inputs):
    ckpt = str(pipeline_inputs / "vtp")
    jtok = JaxTokenizer.from_checkpoint(ckpt, img_size=32)
    tok = VTPTokenizer.from_checkpoint(ckpt, device="cpu", img_size=32)
    assert tok.latent_size == jtok.latent_size == 2 and tok.embed_dim == jtok.embed_dim == 16
    x = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = jtok.encode_images(x)
    got = tok.encode_images(x).numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    # a data_sharding that is not a DeviceMesh raises (a mesh encodes:
    # tests/test_torch_parallel_serve.py)
    with pytest.raises(TypeError):
        VTPTokenizer.from_checkpoint(ckpt, device="cpu", data_sharding=object())
    # the int8 encoder: JAX's int8 tokenizer on the same checkpoint
    want = JaxTokenizer.from_checkpoint(ckpt, img_size=32, quantize_int8=True).encode_images(x)
    got = VTPTokenizer.from_checkpoint(ckpt, device="cpu", img_size=32,
                                       quantize_int8=True).encode_images(x).numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def _run(args, **env):
    res = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1", **env})
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _extract_args(root, out):
    return ["--model_path", str(root / "vtp"), "--data_path", str(root / "imgs"),
            "--output_dir", str(out), "--image_size", "32", "--batch_size", "4",
            "--num_workers", "2", "--shard_size", "8"]


@pytest.fixture(scope="module")
def latent_dir(pipeline_inputs):
    root = pipeline_inputs
    _run(["-m", "vtp_tpu_torch.tools.extract_latents", *_extract_args(root, root / "port"),
          "--device", "cpu"])
    return root / "port" / "latents" / "vtp" / "imgnet32_normimagenet"


def test_extract_cli_matches_the_jax_cli(pipeline_inputs, latent_dir):
    root = pipeline_inputs
    _run(["tools/extract_latents.py", *_extract_args(root, root / "jax")], JAX_PLATFORMS="cpu")
    jax_dir = root / "jax" / "latents" / "vtp" / "imgnet32_normimagenet"
    got, want = tlatents.list_latent_shards(str(latent_dir)), jlatents.list_latent_shards(
        str(jax_dir))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2  # 12 images in shards of 8: 8 + 4
    for g, w in zip(got, want):
        g, w = load_file(g), load_file(w)
        assert np.array_equal(g["labels"], w["labels"])
        for key in ("latents", "latents_flip"):
            assert g[key].shape == w[key].shape
            assert np.abs(g[key] - w[key]).max() <= 5e-2 * np.abs(w[key]).max(), key
        # the flipped encode is of the flipped images
        assert not np.array_equal(g["latents"], g["latents_flip"])
    mean, std = tlatents.load_latent_stats(str(latent_dir))
    assert mean.shape == std.shape == (1, 16, 1, 1) and (std > 0).all()


DIT_ARGS = ["--preset", "DiT-L/1", "--depth", "2", "--dim", "64", "--in_channels", "16",
            "--input_size", "2", "--device", "cpu"]


def test_train_resume_and_sample_clis(pipeline_inputs, latent_dir):
    root = pipeline_inputs
    ckpt = root / "dit_ckpt"
    train = ["-m", "vtp_tpu_torch.tools.train_dit", "--latent_dir", str(latent_dir), *DIT_ARGS,
             "--batch_size", "4", "--accum_steps", "2", "--accum_dtype", "bf16",
             "--moment_dtype", "bf16", "--log_every", "1", "--out", str(ckpt)]
    out = _run([*train, "--steps", "2"])
    assert "step 2: loss" in out and "saved checkpoint at step 2" in out
    out = _run([*train, "--steps", "3", "--resume"])
    assert "resumed from step 2" in out and "step 1:" not in out and "step 3: loss" in out
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]

    samples = root / "samples"
    out = _run(["-m", "vtp_tpu_torch.tools.sample_dit", "--dit_ckpt", str(ckpt),
                "--model_path", str(root / "vtp"), "--latent_dir", str(latent_dir), *DIT_ARGS,
                "--num_samples", "6", "--batch_size", "4", "--num_steps", "4",
                "--cfg_scale", "1.5", "--out", str(samples), "--save_npz"])
    assert "saved (6, 32, 32, 3) to samples.npz" in out
    pngs = sorted(p for p in os.listdir(samples) if p.endswith(".png"))
    assert pngs == [f"sample_{i:06d}.png" for i in range(6)]
    with np.load(samples / "samples.npz") as z:
        arr = z["arr_0"]
    assert arr.shape == (6, 32, 32, 3) and arr.dtype == np.uint8 and arr.std() > 0


def test_int8_flags_raise(pipeline_inputs, latent_dir):
    """The ``--int8`` flags, which raised before the int8 tier was ported,
    now run at depth 2: the int8 extraction's shards within JAX's int8
    cosine gate (> 0.99) of the float extraction's, labels equal; the int8
    DiT's samples beside the float DiT's from the same seed, on a train
    state of its own whose adaLN-zero leaves are drawn (a fresh DiT
    predicts exactly 0)."""
    from vtp_tpu_torch.checkpoint import save_train_state
    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import DiTTrainConfig, init_dit_state
    from vtp_tpu_torch.tools import extract_latents, sample_dit

    root = pipeline_inputs
    gen = torch.Generator().manual_seed(4)
    state = init_dit_state(make_dit_config("DiT-L/1", depth=2, dim=64, in_channels=16,
                                           input_size=2), DiTTrainConfig(total_steps=1), gen,
                           device="cpu")
    with torch.no_grad():
        for name, p in state.ema.named_parameters():
            if ".ada." in name or name.startswith("final."):
                p.normal_(0.0, 0.02, generator=gen)
    save_train_state(str(root / "int8_dit"), state, step=1)
    out = extract_latents.main([*_extract_args(root, root / "int8"), "--device", "cpu", "--int8"])
    got, want = tlatents.list_latent_shards(out), tlatents.list_latent_shards(str(latent_dir))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        g, w = load_file(g), load_file(w)
        assert np.array_equal(g["labels"], w["labels"])
        for key in ("latents", "latents_flip"):
            a, b = g[key].ravel(), w[key].ravel()
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99, key
    args = ["--dit_ckpt", str(root / "int8_dit"), "--model_path", str(root / "vtp"),
            "--latent_dir", str(latent_dir), *DIT_ARGS, "--num_samples", "4",
            "--batch_size", "4", "--num_steps", "4", "--save_npz"]
    int8 = sample_dit.main([*args, "--out", str(root / "int8_samples"), "--int8"])
    ref = sample_dit.main([*args, "--out", str(root / "float_samples")])
    assert int8.shape == ref.shape == (4, 32, 32, 3) and int8.dtype == np.uint8
    assert int8.std() > 0 and not np.array_equal(int8, ref)
