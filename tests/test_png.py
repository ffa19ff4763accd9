"""The numpy + zlib PNG writer and the cv2-free colormap/dilation behind
the saveDepthMaps artifacts, checked against OpenCV where it is installed;
and the dense map's explicit cv2 requirement."""

import builtins

import numpy as np
import pytest

from dvs_mcemvs_tpu.io import outputs


@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (31, 17, 3), (480, 640, 3)])
def test_png_round_trip_through_cv2(tmp_path, shape):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    outputs._imwrite(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = img[..., ::-1] if img.ndim == 3 else img   # cv2 reads BGR
    np.testing.assert_array_equal(back, want)


def test_png_rejects_other_layouts():
    with pytest.raises(ValueError, match="PNG image"):
        outputs.png_bytes(np.zeros((4, 4, 2), np.uint8))


def test_png_header_and_chunks():
    data = outputs.png_bytes(np.zeros((2, 3), np.uint8))
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data[12:16] == b"IHDR" and data[-8:-4] == b"IEND"


def test_jet_colormap_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    v = np.arange(256, dtype=np.uint8)[:, None]
    want = cv2.applyColorMap(v, cv2.COLORMAP_JET)[:, 0, ::-1].astype(int)
    got = outputs.jet_colormap(v)[:, 0].astype(int)
    assert np.abs(got - want).max() <= 1   # OpenCV samples a 64-entry table


def test_dilate_cross3_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    img = np.zeros((40, 50, 3), np.uint8)
    m = rng.random((40, 50)) < 0.1
    img[m] = rng.integers(1, 256, (m.sum(), 3))
    want = cv2.dilate(img, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3)))
    np.testing.assert_array_equal(outputs.dilate_cross3(img), want)


def test_save_depth_maps_writes_pngs(tmp_path):
    rng = np.random.default_rng(2)
    depth = rng.uniform(1, 5, (24, 32)).astype(np.float32)
    conf = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    mask = (rng.random((24, 32)) < 0.3).astype(np.uint8)
    prefix = str(tmp_path / "t_")
    outputs.save_depth_maps(depth, conf, mask, 1.0, 5.0, "fused", prefix)
    for name in ("confidence_map_negated_fused.png",
                 "inv_depth_colored_dilated_fused.png"):
        with open(prefix + name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "t_depth_points_fused.txt").stat().st_size > 0


def test_densify_without_cv2_names_the_flag(monkeypatch):
    from dvs_mcemvs_tpu.ops import extract
    from dvs_mcemvs_tpu.ops.depth_vector import DepthVector

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    res = extract.DepthMapResult(
        depth=np.zeros((4, 4)), confidence=np.zeros((4, 4)),
        mask=np.ones((4, 4), np.uint8), depth_dense=None,
        depth_indices=np.zeros((4, 4), np.int32))
    with pytest.raises(ImportError, match="--nosave_dense"):
        extract.densify_host(res, DepthVector("linear", 1.0, 5.0, 8))
