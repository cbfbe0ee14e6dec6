"""Port parity for the mask-editing half of the editing workflow:
fenerf_tpu_torch/utils/mask_tools.py against fenerf_tpu.utils.mask_tools
op for op, exact (the morphology against cv2's, on classes that touch the
border, iterations 1-4 and the derived count); the edit_mask CLI against
the JAX CLI, array for array; the paint_ui server's apply_op and HTTP
endpoints (as tests/test_paint_ui.py drives the JAX one) and its edit log;
edit_log_video's log_to_frames against the JAX package's, exact, and its
AVI read back.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
from PIL import Image

from fenerf_tpu.utils import mask_tools as jmt
from fenerf_tpu_torch.utils import mask_tools as tmt
from fenerf_tpu_torch.utils.image import read_png
from fenerf_tpu_torch.utils.video import read_avi


def _blobs(seed, h=24, w=20):
    """A label map of a few rectangles over skin, hair along the top edge
    and the right border, a nose blob at the bottom-left corner."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    m[2:h - 2, 2:w - 2] = 1
    m[:5, :] = 13                       # hair: the top border
    m[:, w - 3:] = 13                   # and the right one
    m[h - 6:, :5] = 2                   # nose at a corner
    for lab in (4, 5, 10, 17, 3, 14, 18):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        m[y:y + rng.integers(2, 6), x:x + rng.integers(2, 6)] = lab
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("label", [13, 2, 4])
@pytest.mark.parametrize("factor", [1.6, 0.5])
def test_scale_semantic_matches_jax(seed, label, factor):
    m = _blobs(seed)
    for it in (None, 1, 2, 3, 4):
        np.testing.assert_array_equal(
            tmt.scale_semantic(m, label, factor, it),
            jmt.scale_semantic(m, label, factor, it), err_msg=str(it))
    assert tmt.scale_semantic(m, 7, factor).tolist() == m.tolist()  # absent
    assert tmt.scale_semantic(m, label, 1.0).tolist() == m.tolist()


def test_morphology_equals_cv2():
    import cv2

    rng = np.random.default_rng(3)
    k = np.ones((3, 3), np.uint8)
    for _ in range(40):
        r = (rng.random((int(rng.integers(3, 30)), int(rng.integers(3, 30))))
             < rng.random()).astype(np.uint8)
        r[0, :] = 1                      # a region on the border
        for it in (1, 2, 3, 4):
            np.testing.assert_array_equal(
                tmt.dilate(r, it), cv2.dilate(r, k, iterations=it) > 0)
            np.testing.assert_array_equal(
                tmt.erode(r, it), cv2.erode(r, k, iterations=it) > 0)


def test_other_ops_match_jax():
    m, ref = _blobs(4), _blobs(5)
    same = np.testing.assert_array_equal
    same(tmt.remove_semantic(m, 13), jmt.remove_semantic(m, 13))
    same(tmt.remove_semantic(m, 4, 0), jmt.remove_semantic(m, 4, 0))
    same(tmt.switch_semantic(m, 4, 5), jmt.switch_semantic(m, 4, 5))
    for labels, off in (((4, 5), (0, 0)), ((10,), (3, -2)), ((2, 13), (-9, 30))):
        same(tmt.transfer_semantic(m, ref, labels, off),
             jmt.transfer_semantic(m, ref, labels, off))
    region = np.random.default_rng(6).random(m.shape) < 0.3
    same(tmt.add_semantic(m, 7, region), jmt.add_semantic(m, 7, region))
    same(tmt.simplify_mask(m), jmt.simplify_mask(m))
    same(tmt.simplify_mask(m, keep=(3, 14)), jmt.simplify_mask(m, keep=(3, 14)))
    same(tmt.colorize(m), jmt.colorize(m))
    same(tmt.color_to_mask(tmt.colorize(m)), m)
    noisy = np.clip(tmt.colorize(m).astype(np.int32) + 9, 0, 255)
    same(tmt.color_to_mask(noisy), jmt.color_to_mask(noisy))
    assert tmt.LABELS == jmt.LABELS


def test_edit_mask_cli_matches_jax(tmp_path):
    from fenerf_tpu.apps.edit_mask import main as jmain
    from fenerf_tpu_torch.apps.edit_mask import main as tmain

    src, ref = str(tmp_path / "mask.png"), str(tmp_path / "ref.png")
    Image.fromarray(_blobs(7), mode="L").save(src)
    Image.fromarray(_blobs(8), mode="L").save(ref)
    ops = ["--op", "switch:left_eye:right_eye", "--op", "scale:hair:1.3",
           "--op", "scale:nose:0.6", "--op", "rect:mouth:3:10:9:14",
           "--op", f"transfer:4,5:{ref}:1:-2", "--op", "remove:hat",
           "--op", "remove:cloth:neck", "--op", "simplify", "--colorize"]
    jmain([src, str(tmp_path / "j.png")] + ops)
    out = tmain([src, str(tmp_path / "t.png")] + ops)
    want = np.asarray(Image.open(tmp_path / "j.png"))
    got = read_png(str(tmp_path / "t.png"))
    assert got.ndim == 2 and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "t_color.png")),
        np.asarray(Image.open(tmp_path / "j_color.png").convert("RGB")))
    assert not np.array_equal(want, _blobs(7))
    with pytest.raises(SystemExit, match="unknown op"):
        tmain([src, str(tmp_path / "x.png"), "--op", "blur:3"])


# ---------------------------------------------------------------------------
# paint_ui over HTTP (tests/test_paint_ui.py's drive of the JAX server)
# ---------------------------------------------------------------------------

@pytest.fixture()
def server(tmp_path):
    from fenerf_tpu_torch.apps.paint_ui import make_server

    mask = np.zeros((16, 16), np.uint8)
    mask[4:12, 4:12] = 1   # skin square
    mask[6:8, 6:8] = 4     # left eye
    src = str(tmp_path / "mask.png")
    out = str(tmp_path / "mask_edit.png")
    Image.fromarray(mask, mode="L").save(src)
    srv, state = make_server(src, out, port=0,
                             log_path=str(tmp_path / "sess.editlog.npz"))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state, out, mask
    srv.shutdown()
    srv.server_close()
    t.join()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def test_page_and_labels(server):
    from fenerf_tpu.apps import paint_ui as jpaint

    base, state, out, mask = server
    page = _get(base + "/").decode()
    assert "FENeRF mask painter" in page and "__PALETTE__" not in page
    assert page == (jpaint._PAGE
                    .replace("__PALETTE__",
                             json.dumps(jpaint.CELEBA_PALETTE.tolist()))
                    .replace("__NAMES__", json.dumps(jpaint.CLASS_NAMES)))
    d = json.loads(_get(base + "/labels"))
    assert d["w"] == d["h"] == 16
    np.testing.assert_array_equal(
        np.asarray(d["labels"], np.uint8).reshape(16, 16), mask)
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/nothing")


def test_ops_save_and_log(server, tmp_path):
    from fenerf_tpu.apps.paint_ui import apply_op as japply
    from fenerf_tpu_torch.apps.paint_ui import apply_op

    base, state, out, mask = server
    d = json.loads(_post(base + "/op", {
        "op": "switch:1,13", "labels": mask.reshape(-1).tolist()}))
    got = np.asarray(d["labels"], np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(got, japply(mask, "switch:1,13"))
    assert "applied" in d["msg"]
    d = json.loads(_post(base + "/op", {
        "op": "bogus:1", "labels": mask.reshape(-1).tolist()}))
    assert "error" in d["msg"]
    e1 = mask.copy()
    e1[0:2, 0:2] = 13
    e2 = e1.copy()
    e2[14:16, 14:16] = 17
    _post(base + "/log", {"labels": e1.reshape(-1).tolist()})
    _post(base + "/log", {"labels": e2.reshape(-1).tolist()})
    msg = _post(base + "/save", {"labels": e2.reshape(-1).tolist()}).decode()
    assert "saved" in msg
    np.testing.assert_array_equal(read_png(out), e2)
    frames = np.load(tmp_path / "sess.editlog.npz")["frames"]
    assert frames.shape == (4, 16, 16)   # initial + 2 edits + save
    np.testing.assert_array_equal(frames[0], mask)
    np.testing.assert_array_equal(frames[-1], e2)
    for spec in ("remove:4", "switch:4,1", "scale:1,1.5", "scale:1,0.5",
                 "simplify"):
        np.testing.assert_array_equal(apply_op(e2, spec), japply(e2, spec))


# ---------------------------------------------------------------------------
# edit_log_video
# ---------------------------------------------------------------------------

def test_log_to_frames_matches_jax():
    from fenerf_tpu.apps.edit_log_video import log_to_frames as jframes
    from fenerf_tpu_torch.apps.edit_log_video import log_to_frames

    rng = np.random.default_rng(9)
    log = rng.integers(0, 19, (3, 16, 12)).astype(np.uint8)
    for side in (None, rng.integers(0, 256, (16, 12, 3), dtype=np.uint8),
                 rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)):
        for hold in (0, 1, 4):
            want, got = jframes(log, side, hold), log_to_frames(log, side,
                                                                hold)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_edit_log_video_cli(tmp_path):
    from fenerf_tpu_torch.apps.edit_log_video import log_to_frames, main

    rng = np.random.default_rng(10)
    log = str(tmp_path / "sess.editlog.npz")
    frames = rng.integers(0, 19, (2, 16, 16)).astype(np.uint8)
    np.savez_compressed(log, frames=frames)
    side = str(tmp_path / "side.jpg")
    Image.fromarray(rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)).save(
        side, quality=90)
    out, video = main(["--log", log, "--side", side, "--fps", "2",
                       "--hold", "3"])
    assert out == str(tmp_path / "sess.editlog.avi")
    back, fps = read_avi(out)
    assert fps == 2 and back.shape == (4, 16, 32, 3)
    jside = np.asarray(Image.open(side).convert("RGB"))
    want = log_to_frames(frames, jside, 3)
    np.testing.assert_array_equal(back, np.stack(want))
    np.testing.assert_array_equal(back, np.stack(video))
