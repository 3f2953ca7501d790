"""The port's native feature library (``cslam_tpu_torch.native``, its own
copy of ``features.cpp`` built into ``cslam_tpu_torch/csrc/build/``)
against the JAX package's ``cslam_tpu.native`` and against the port's numpy
oracle (``cslam_tpu_torch.native.fallback``), on the CPU.

Limits: bit for bit everywhere (keypoints, scores, BRIEF, steered BRIEF,
hamming matches with and without the ratio test); the steered angles within
1e-6 rad of the numpy oracle's (as the JAX package's own test allows) and
equal to the JAX package's library's. The build never writes the JAX
package's ``native/libcslam_native.so``, and a failed build raises.
"""
import hashlib
import pathlib

import numpy as np
import pytest

from cslam_tpu import native as J
from cslam_tpu_torch import native as T
from cslam_tpu_torch.native import fallback
from test_visual_frontend import make_world, pose_xyz_yaw, render
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_LIB = REPO / "native" / "libcslam_native.so"


@pytest.fixture(scope="module")
def images():
    """Rendered landmark views (two poses, two worlds), one rotated by 30
    degrees, and uniform noise."""
    from scipy import ndimage
    rng = np.random.default_rng(0)
    pts, tex = make_world(rng)
    a, _ = render(pts, tex, np.eye(4))
    b, _ = render(pts, tex, pose_xyz_yaw(0.2, 0.1, 0.0, yaw=0.05))
    c, _ = render(*make_world(np.random.default_rng(9), n=80), np.eye(4))
    rot = ndimage.rotate(a.astype(np.float32), 30, reshape=False, order=1,
                         mode="constant").astype(np.uint8)
    noise = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    return [a, b, c, rot, noise]


def test_port_library_is_loaded():
    assert T.available()
    assert T._lib is not None


@pytest.mark.parametrize("threshold,max_kp", [(25, 300), (18, 64), (40, 512)])
def test_fast_detect_matches_reference(images, threshold, max_kp):
    for img in images:
        xy, score = T.fast_detect(img, threshold, max_kp)
        xy_j, score_j = J.fast_detect(img, threshold, max_kp)
        np.testing.assert_array_equal(xy, xy_j)
        np.testing.assert_array_equal(score, score_j)
    assert len(T.fast_detect(images[0], threshold, max_kp)[0]) > 30


def test_brief_and_steered_brief_match_reference(images):
    for img in images:
        kp, _ = T.fast_detect(img, 20, 256)
        np.testing.assert_array_equal(T.brief_describe(img, kp),
                                      J.brief_describe(img, kp))
        d, ang = T.steered_brief_describe(img, kp)
        d_j, ang_j = J.steered_brief_describe(img, kp)
        np.testing.assert_array_equal(d, d_j)
        np.testing.assert_array_equal(ang, ang_j)
    empty = np.zeros((0, 2), np.int32)
    assert T.brief_describe(images[0], empty).shape == (0, 32)
    assert T.steered_brief_describe(images[0], empty)[1].shape == (0,)


@pytest.mark.parametrize("ratio", [0.0, 0.8, 1.0])
def test_hamming_match_matches_reference(images, ratio):
    """Rendered views and the JAX test's adversarial descriptors (an exact
    match, its ambiguous duplicate, all-zero border sentinels)."""
    kp_a, _ = T.fast_detect(images[0], 25, 300)
    kp_b, _ = T.fast_detect(images[1], 25, 300)
    cases = [(T.brief_describe(images[0], kp_a),
              T.brief_describe(images[1], kp_b), 40)]
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (70, 32), dtype=np.uint8)
    b[5] = a[3]
    b[11] = a[3]
    a[7] = 0
    b[9] = 0
    cases.append((a, b, 200))
    for da, db, max_dist in cases:
        got = T.hamming_match(da, db, max_dist=max_dist, ratio=ratio)
        np.testing.assert_array_equal(
            got, J.hamming_match(da, db, max_dist=max_dist, ratio=ratio))
        np.testing.assert_array_equal(
            got, fallback.hamming_match(da, db, max_dist, ratio))
    assert len(T.hamming_match(*cases[0][:2], max_dist=40)) > 20


def test_native_matches_numpy_oracle(images):
    """As the JAX package's ``TestNativeFeatures`` and
    ``TestSteeredBrief.test_native_matches_fallback`` hold its library."""
    img = images[0]
    xy_n, _ = T.fast_detect(img, 25, 300)
    xy_f, _ = fallback.fast_detect(img, 25, 10000)
    set_f = set(map(tuple, xy_f.tolist()))
    assert len(xy_n) > 30
    assert all(tuple(p) in set_f for p in xy_n.tolist())
    np.testing.assert_array_equal(T.brief_describe(img, xy_n),
                                  fallback.brief_describe(img, xy_n))
    kp, _ = T.fast_detect(images[2], 20, 128)
    d_n, a_n = T.steered_brief_describe(images[2], kp)
    d_f, a_f = fallback.steered_brief_describe(images[2], kp)
    assert np.array_equal(d_n, d_f)
    np.testing.assert_allclose(a_n, a_f, atol=1e-6)


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() \
        else None


def test_build_leaves_reference_library_unchanged(tmp_path):
    before = (_digest(REF_LIB), REF_LIB.stat().st_mtime_ns
              if REF_LIB.exists() else None)
    out = T.build(build_dir=tmp_path)             # a fresh compile
    T.bind(out)
    assert out.parent == tmp_path and out.name.startswith("libcslam_features")
    assert T.library_path().parent == REPO / "cslam_tpu_torch" / "csrc" / \
        "build"
    assert (_digest(REF_LIB), REF_LIB.stat().st_mtime_ns
            if REF_LIB.exists() else None) == before
    assert [p.name for p in tmp_path.iterdir()] == [out.name]


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    bad = tmp_path / "features.cpp"
    bad.write_text("extern \"C\" int cslam_fast_detect( {\n")
    with pytest.raises(T.NativeBuildError,
                       match="(?s)g\\+\\+ failed.*error:"):
        T.build(source=bad, build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))         # no half-written library
    monkeypatch.setattr(T, "SOURCE", bad)
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(T, "_lib", None)
    monkeypatch.setattr(T, "_error", None)
    assert not T.available()
    with pytest.raises(T.NativeBuildError, match="g\\+\\+ failed"):
        T.fast_detect(np.zeros((32, 32), np.uint8))
    with pytest.raises(T.NativeBuildError):        # kept, not retried
        T.hamming_match(np.zeros((1, 32), np.uint8),
                        np.zeros((1, 32), np.uint8))


def test_missing_symbol_raises(tmp_path):
    src = tmp_path / "partial.cpp"
    src.write_text("extern \"C\" int cslam_fast_detect() { return 0; }\n")
    with pytest.raises(T.NativeBuildError, match="cslam_brief_describe"):
        T.bind(T.build(source=src, build_dir=tmp_path))
