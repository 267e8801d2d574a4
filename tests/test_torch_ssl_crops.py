"""The multi-crop SSL pipeline (``data/ssl_crops.py``) and the schedules
(``train/schedules.py``) against the JAX package's on the same seeds:
crops, collate and mask bookkeeping bit for bit; ``CosineScheduler``
tables equal; ``cosine_schedule`` within 1e-6 rel (float32; numpy's and
XLA's cos differ by an ulp)."""

import numpy as np
import pytest
from PIL import Image

from vtp_tpu.data import ImageFolder as JaxImageFolder
from vtp_tpu.data import ssl_crops as jax_crops
from vtp_tpu.train import schedules as jax_schedules
from vtp_tpu_torch.data import (
    ImageFolder,
    MultiCropDataset,
    MultiCropTransform,
    collate_multicrop,
    make_mask_bookkeeping,
    random_resized_crop,
)
from vtp_tpu_torch.train.schedules import CosineScheduler, cosine_schedule


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two classes of seeded PNGs of odd sizes (wide, tall, tiny)."""
    root = tmp_path_factory.mktemp("ssl_imgs")
    rng = np.random.default_rng(0)
    for cls, shapes in (("cat", [(80, 96), (40, 150), (17, 23)]), ("dog", [(96, 80), (64, 64)])):
        (root / cls).mkdir()
        for i, (h, w) in enumerate(shapes):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(root / cls / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("scale", [(0.08, 1.0), (0.32, 1.0), (0.05, 0.32), (2.0, 3.0)])
def test_random_resized_crop_bit_equal(image_dir, scale):
    """Scale (2, 3) never fits and takes the center-crop fallback."""
    for path, _ in ImageFolder(image_dir).samples:
        img = Image.open(path).convert("RGB")
        got = random_resized_crop(img, 24, np.random.default_rng(5), scale=scale)
        want = jax_crops.random_resized_crop(img, 24, np.random.default_rng(5), scale=scale)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dataset_and_collate_bit_equal(image_dir):
    t = MultiCropTransform(global_size=32, local_size=16, n_local=3)
    jt = jax_crops.MultiCropTransform(global_size=32, local_size=16, n_local=3)
    ds = MultiCropDataset(ImageFolder(image_dir), t, seed=7)
    jds = jax_crops.MultiCropDataset(JaxImageFolder(image_dir), jt, seed=7)
    ds.set_epoch(2)
    jds.set_epoch(2)
    items, jitems = [ds[i] for i in range(len(ds))], [jds[i] for i in range(len(jds))]
    for (g, l, label), (jg, jl, jlabel) in zip(items, jitems):
        assert g.shape == (2, 3, 32, 32) and l.shape == (3, 3, 16, 16) and g.dtype == np.float32
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(l, jl)
        assert label == jlabel
    # a second pass (the visits-based epoch) draws other crops, as in JAX
    again, jagain = ds[0], jds[0]
    np.testing.assert_array_equal(again[0], jagain[0])
    assert not np.array_equal(again[0], items[0][0])
    for got, want in zip(collate_multicrop(items[:4]), jax_crops.collate_multicrop(jitems[:4])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    g, l, _ = collate_multicrop(items[:4])
    np.testing.assert_array_equal(g[5], items[1][0][1])  # [crop0 of all | crop1 of all]
    np.testing.assert_array_equal(l[4 * 2 + 1], items[1][1][2])


def test_no_local_crops(image_dir):
    t = MultiCropTransform(global_size=16, local_size=8, n_local=0)
    g, l, _ = MultiCropDataset(ImageFolder(image_dir), t)[1]
    assert g.shape == (2, 3, 16, 16) and l.shape == (0, 3, 8, 8)
    _, lc, _ = collate_multicrop([(g, l, 0), (g, l, 1)])
    assert lc.shape == (0, 3, 8, 8)


@pytest.mark.parametrize("n_imgs,n_patches,ratio,upper", [(4, 16, 0.3, 0.5), (8, 256, 0.3, 0.5),
                                                          (2, 4, 0.9, 0.5), (6, 9, 0.0, 0.5)])
def test_mask_bookkeeping_bit_equal(n_imgs, n_patches, ratio, upper):
    got = make_mask_bookkeeping(np.random.default_rng(3), n_imgs, n_patches, ratio, upper)
    want = jax_crops.make_mask_bookkeeping(np.random.default_rng(3), n_imgs, n_patches, ratio,
                                           upper)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", [
    dict(base_value=1e-3, final_value=1e-6, total_iters=100, warmup_iters=10),
    dict(base_value=0.04, final_value=0.2, total_iters=50),
    dict(base_value=0.996, final_value=1.0, total_iters=40, warmup_iters=5, freeze_iters=3,
         start_warmup_value=0.5, trunc_extra=0.25),
])
def test_cosine_scheduler_equals_jax(kw):
    got, want = CosineScheduler(**kw), jax_schedules.CosineScheduler(**kw)
    np.testing.assert_array_equal(got.schedule, want.schedule)
    for it in (0, 1, kw["total_iters"] - 1, kw["total_iters"], kw["total_iters"] + 7):
        assert got[it] == want[it]


@pytest.mark.parametrize("args", [(1e-3, 1e-6, 100, 10, 0.0), (0.04, 0.2, 50, 0, 0.0),
                                  (0.996, 1.0, 30, 5, 0.5)])
def test_cosine_schedule_matches_jax(args):
    got, want = cosine_schedule(*args), jax_schedules.cosine_schedule(*args)
    for step in range(0, 120):
        g, w = float(got(step)), float(want(step))
        assert abs(g - w) <= 1e-6 * abs(w), (step, g, w)
