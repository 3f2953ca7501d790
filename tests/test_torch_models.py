"""Parity of the port's VPR models (``cslam_tpu_torch.models``) with the JAX
package's, on the CPU, at small sizes.

- preprocessing against ``normalize_and_resize``: within 1e-5 absolute in
  [0, 1] image units (the bicubic resize antialiases in both; float32
  roundings differ by up to about 5e-6);
- CosPlace ResNet18 against ``GeoLocalizationNet.apply`` with the weights
  carried across by ``cosplace_state_dict_from_jax``: cosine >= 0.99999
  (float32 convolutions summed in another order);
- every backbone and NetVLAD (VLAD and PCA) against the torch-oracle
  descriptors stored in ``tests/data/vpr_goldens.npz``: cosine >= 0.999, as
  ``tests/test_golden_checkpoints.py`` holds the JAX package (the goldens
  are stored in float16);
- the bf16 trunk against float32: cosine > 0.98, as the JAX package's own
  mixed-precision test;
- ``"disable"`` mode: the same random descriptors as the JAX package.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.models import golden as jgolden
from cslam_tpu_torch.convert import (cosplace_state_dict_from_jax,
                                     netvlad_state_dict_from_jax)
from cslam_tpu_torch.models import golden, make_global_descriptor, preprocess
from cslam_tpu_torch.models.convert import load_cosplace
from cslam_tpu_torch.models.cosplace import CosPlace, GeoLocalizationNet
from cslam_tpu_torch.models.netvlad import NetVLAD
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "data", "vpr_goldens.npz")
COS_JAX = 0.99999
COS_GOLDEN = 0.999


def _cos(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


def _port_cosplace(sd, backbone="resnet18"):
    model = GeoLocalizationNet(backbone=backbone, fc_output_dim=64)
    return load_cosplace(model, sd).eval()


def _nchw(images):
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1,
                                                                  2)))


@pytest.fixture(scope="module")
def stored():
    return np.load(GOLDENS)


@pytest.mark.parametrize("shape,crop", [((2, 100, 130, 3), 90),
                                        ((1, 480, 640, 3), 376)])
def test_preprocess_matches_jax(shape, crop):
    from cslam_tpu.models import preprocess as jpre
    images = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jpre.preprocess(images, crop))
    got = preprocess.preprocess(images, crop, torch.device("cpu"))
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    # in [0, 1] image units, before the normalization's 1/std (up to 4.4x)
    # magnifies the resize's float32 rounding differences
    std, mean = preprocess.IMAGENET_STD, preprocess.IMAGENET_MEAN
    np.testing.assert_allclose(got.numpy() * std + mean, want * std + mean,
                               rtol=0, atol=1e-5)


def test_golden_state_dicts_are_the_jax_packages():
    """The port's numpy copy of the seeded checkpoints is byte for byte the
    JAX package's (the stored goldens pin both)."""
    for make in ("golden_cosplace_state_dict", "golden_netvlad_state_dict",
                 "golden_pca"):
        a, b = getattr(golden, make)(), getattr(jgolden, make)()
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), (make, key)
    assert np.array_equal(golden.golden_images(), jgolden.golden_images())


@pytest.mark.parametrize("backbone", ["resnet18", "vgg16"])
def test_weights_from_jax_invert_the_reference_conversion(backbone):
    """``cosplace_state_dict_from_jax`` undoes ``convert_cosplace`` exactly:
    conv HWIO -> OIHW, fc transposed, BatchNorm statistics mapped back."""
    from cslam_tpu.models.convert import convert_cosplace, convert_netvlad
    sd = golden.golden_cosplace_state_dict(backbone=backbone)
    back = cosplace_state_dict_from_jax(convert_cosplace(sd, backbone=backbone))
    assert back.keys() == sd.keys()
    for key in sd:
        assert np.array_equal(back[key], sd[key]), key
    if backbone == "vgg16":
        nsd = golden.golden_netvlad_state_dict()
        back = netvlad_state_dict_from_jax(convert_netvlad(nsd))
        assert back.keys() == nsd.keys()
        for key in nsd:
            assert np.array_equal(back[key], nsd[key]), key


def test_cosplace_resnet18_matches_jax_apply():
    from cslam_tpu.models.convert import convert_cosplace
    from cslam_tpu.models.cosplace import GeoLocalizationNet as JNet
    images = golden.golden_images()
    variables = convert_cosplace(golden.golden_cosplace_state_dict())
    want = np.asarray(JNet(backbone="resnet18", fc_output_dim=64).apply(
        variables, jnp.asarray(images)))
    model = _port_cosplace(cosplace_state_dict_from_jax(variables))
    with torch.no_grad():
        got = model(_nchw(images)).numpy()
    assert got.shape == want.shape == (2, 64)
    cos = _cos(got, want)
    assert cos.min() >= COS_JAX, cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("backbone,key", [
    ("resnet18", "cosplace"), ("resnet50", "cosplace_resnet50"),
    ("resnet101", "cosplace_resnet101"), ("resnet152", "cosplace_resnet152"),
    ("vgg16", "cosplace_vgg16")])
def test_cosplace_backbones_match_torch_goldens(stored, backbone, key):
    model = _port_cosplace(
        golden.golden_cosplace_state_dict(backbone=backbone), backbone)
    with torch.no_grad():
        got = model(_nchw(golden.golden_images())).numpy()
    cos = _cos(got, stored[key])
    assert cos.min() >= COS_GOLDEN, cos


def test_netvlad_vlad_and_pca_match_torch_goldens(stored):
    model = NetVLAD({"frontend.nn_checkpoint": "golden"},
                    torch_state_dict=golden.golden_netvlad_state_dict(),
                    pca=golden.golden_pca(), device="cpu")
    images = golden.golden_images()
    vlad = model.compute_vlad(images)
    assert vlad.shape == (2, NetVLAD.RAW_DIM)
    cos = _cos(vlad, stored["netvlad_vlad"])
    assert cos.min() >= COS_GOLDEN, cos
    desc = model.forward_preprocessed(images)
    assert desc.shape == (2, 128)
    cos = _cos(desc, stored["netvlad_pca"])
    assert cos.min() >= COS_GOLDEN, cos


@pytest.mark.parametrize("technique", ["cosplace", "netvlad"])
def test_bf16_trunk_close_to_f32(technique):
    images = np.random.default_rng(3).integers(0, 255, (2, 120, 150, 3),
                                               dtype=np.uint8)
    descs = {}
    for dtype in ("float32", "bfloat16"):
        model = make_global_descriptor(
            {"frontend.global_descriptor_technique": technique,
             "frontend.nn_checkpoint": "random",
             "frontend.cosplace.descriptor_dim": 32,
             "frontend.image_crop_size": 112,
             "frontend.compute_dtype": dtype, "robot_id": 0}, device="cpu")
        descs[dtype] = model.compute_embeddings(images)
    cos = _cos(descs["float32"], descs["bfloat16"])
    assert np.all(cos > 0.98), cos


@pytest.mark.parametrize("technique,dim", [("cosplace", 64),
                                           ("netvlad", 128)])
def test_disable_mode_same_random_descriptors_as_jax(technique, dim):
    from cslam_tpu.models import make_global_descriptor as jmake
    params = {"frontend.global_descriptor_technique": technique,
              "frontend.nn_checkpoint": "disable",
              "frontend.cosplace.descriptor_dim": 64, "robot_id": 3}
    port, ref = make_global_descriptor(params), jmake(params)
    image = np.zeros((100, 100, 3), np.uint8)
    for _ in range(2):
        got, want = port.compute_embedding(image), ref.compute_embedding(image)
        assert got.shape == (dim,)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port.compute_embedding_finish(port.compute_embedding_begin(image)),
        ref.compute_embedding_finish(ref.compute_embedding_begin(image)))
    np.testing.assert_array_equal(port.compute_embeddings(image[None]),
                                  ref.compute_embeddings(image[None]))


def test_random_mode_is_the_golden_checkpoint_and_begin_finish_agree():
    params = {"frontend.nn_checkpoint": "random",
              "frontend.cosplace.descriptor_dim": 64,
              "frontend.image_crop_size": 96, "robot_id": 0}
    model = CosPlace(params, device="cpu")
    ref = _port_cosplace(golden.golden_cosplace_state_dict())
    for name, value in ref.state_dict().items():
        assert torch.equal(model.model.state_dict()[name], value), name
    image = np.random.default_rng(2).integers(0, 255, (100, 120, 3),
                                              dtype=np.uint8)
    one = model.compute_embedding_finish(model.compute_embedding_begin(image))
    assert one.shape == (64,)
    np.testing.assert_allclose(one, model.compute_embedding(image), atol=1e-6)


@pytest.mark.parametrize("technique", ["cosplace", "netvlad"])
def test_reference_checkpoint_file_loads(tmp_path, technique):
    """A reference ``.pth`` from ``frontend.nn_checkpoint``: CosPlace as a
    DataParallel state_dict, NetVLAD as the ``{'state_dict': ...}`` payload
    with ``encoder.module.`` wrappers (reference ``netvlad.py:182-194``)."""
    if technique == "cosplace":
        sd = golden.golden_cosplace_state_dict(fc_output_dim=16)
        payload = {"module." + k: torch.from_numpy(np.asarray(v))
                   for k, v in sd.items()}
    else:
        sd = golden.golden_netvlad_state_dict()
        payload = {"epoch": 3, "best_score": 0.5, "state_dict": {
            k.replace("encoder.", "encoder.module."):
                torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}
    path = tmp_path / f"{technique}.pth"
    torch.save(payload, str(path))
    model = make_global_descriptor(
        {"frontend.global_descriptor_technique": technique,
         "frontend.nn_checkpoint": str(path),
         "frontend.cosplace.descriptor_dim": 16}, device="cpu")
    loaded = model.model.state_dict()
    assert loaded.keys() == sd.keys()
    for key, value in sd.items():
        assert np.array_equal(loaded[key].numpy(), value), key


def test_fit_pca_matches_jax():
    from cslam_tpu.models.pca import fit_pca as jfit
    from cslam_tpu_torch.models.pca import fit_pca
    rng = np.random.default_rng(4)
    data = rng.standard_normal((200, 32)).astype(np.float32)
    data[:, :4] *= 10  # dominant directions
    ours = fit_pca(data, out_dim=8, whiten=True, device="cpu")
    theirs = jfit(data, out_dim=8, whiten=True)
    np.testing.assert_allclose(ours["mean"], theirs["mean"], atol=1e-5)
    dots = np.abs(np.sum(ours["components"] * theirs["components"], axis=1))
    norms = (np.linalg.norm(ours["components"], axis=1)
             * np.linalg.norm(theirs["components"], axis=1))
    assert np.all(dots / norms > 0.999)   # the same axes, up to sign


def test_scancontext_still_raises_naming_its_item(monkeypatch):
    """ROADMAP item 11 (the lidar path) is ported, so ScanContext no longer
    raises ``NotImplementedError``. Like every entry point it still raises
    when no device is named and no GPU is there, and it runs on the device
    the caller names."""
    from cslam_tpu_torch.ops.scancontext import points_to_scancontext_np
    params = {"frontend.global_descriptor_technique": "scancontext"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU is available"):
        make_global_descriptor(params)
    pts = np.random.default_rng(0).uniform(-50, 50, (500, 3))
    got = make_global_descriptor(params, device="cpu").compute_embedding(pts)
    assert np.array_equal(got, points_to_scancontext_np(pts).reshape(-1))
