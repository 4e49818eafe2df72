"""Rendering through the port (``eval/render.py``, ``render-keypoints``,
``detect --render/--html``, the engine's snapshot PNG) against usip_tpu on
the CPU.

From the same 3- and 4-column keypoint bins (an export of usip_tpu's
seeded detector, its ``.msgpack``, over the synthetic eval frames),
``run_render`` of both packages renders the same frames with the same
counts and captions, writes the same ``index.html`` bytes, and PNGs of the
same pixel size and the same bytes (matplotlib's Agg output is
deterministic for the same inputs here).
``detect --render --html`` from one usip_tpu detector (its ``.msgpack``,
and ``export_detector_state_dict`` of it as the port's ``.pth``) writes the
same files, the same gallery and PNGs of the same size (the keypoints
differ: the packages draw their nodes from their own generators). The
engine's snapshot writes the ``.npz`` and, beside it, usip_tpu's PNG of
those arrays, byte for byte; without matplotlib it writes the ``.npz``
alone, while ``render-keypoints`` and ``detect --render`` raise.
"""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from usip_tpu import cli as jax_cli
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.eval import render as jax_render
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.loop import init_detector_state as jax_init_detector_state
from usip_tpu.train.torch_import import export_detector_state_dict
from usip_tpu.utils.vis import save_keypoint_scene as jax_save_keypoint_scene
from usip_tpu_torch import cli
from usip_tpu_torch.config import get_config
from usip_tpu_torch.eval import render
from usip_tpu_torch.eval.export_runner import run_export
from usip_tpu_torch.train.checkpoint import restore_checkpoint
from usip_tpu_torch.train.loop import DetectorEngine, init_detector_state

torch.set_num_threads(1)

TINY = {"data.input_pc_num": 128, "data.node_num": 16, "detector.c1": 16,
        "detector.c2": 32, "detector.node_knn_k": 4, "train.batch_size": 4,
        "detector.compute_dtype": "float32"}
FLAGS = ["--dataset", "modelnet"] + [
    a for k, v in TINY.items() for a in ("--override", f"{k}={v}")]


def _png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """usip_tpu's seeded detector (``.msgpack``, and its state dict as a
    ``.pth``) and 3- and 4-column exports of the synthetic frames with it."""
    tmp = tmp_path_factory.mktemp("render")
    jcfg = jax_get_config("modelnet", **TINY)
    _, state = jax_init_detector_state(jcfg, 0)
    ckpt = str(tmp / "det.msgpack")
    jax_save_checkpoint(ckpt, state)
    pth = str(tmp / "det.pth")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in
                export_detector_state_dict(state.variables).items()}, pth)
    bins = {}
    for dim in (3, 4):
        bins[dim] = str(tmp / f"kp{dim}")
        run_export(get_config("modelnet", **TINY), ckpt, bins[dim],
                   desired_num=8, synthetic=True, with_sigmas=dim == 4,
                   device="cpu")
    return {"tmp": tmp, "msgpack": ckpt, "pth": pth, "bins": bins}


def _cfgs():
    return get_config("modelnet", **TINY), jax_get_config("modelnet", **TINY)


def _same_gallery(ours, ref, out, ref_out, pngs):
    """Same files, the same index.html bytes (when written), and PNGs of the
    same pixel size and bytes."""
    assert _files(out) == _files(ref_out)
    names = [f for f in _files(out) if f.endswith(".png")]
    assert len(names) == pngs
    for f in names:
        a, b = os.path.join(out, f), os.path.join(ref_out, f)
        assert _png_size(a) == _png_size(b) and _png_size(a)[0] > 100
        assert _read(a) == _read(b), f
    if ref.get("html"):
        assert os.path.basename(ours["html"]) == "index.html"
        assert _read(ours["html"]) == _read(ref["html"])


@pytest.mark.parametrize("dim,threshold,html", [
    (4, None, True),   # the dataset's default cut (modelnet 0.04)
    (4, 1e9, True),    # nothing filtered
    (4, 1e-12, False),  # everything filtered, still renders the cloud
    (3, None, True),   # 3-column bins render unfiltered
])
def test_run_render_matches_usip_tpu(exported, tmp_path, dim, threshold,
                                     html):
    cfg, jcfg = _cfgs()
    kw = dict(kp_dim=dim, sigma_threshold=threshold, max_frames=3,
              html=html, synthetic=True, seed=5)
    kp_dir = exported["bins"][dim]
    out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    ours = render.run_render(cfg, kp_dir, out, **kw)
    ref = jax_render.run_render(jcfg, kp_dir, ref_out, **kw)
    assert ours["rendered"] == ref["rendered"] == 3
    assert ours["skipped"] == ref["skipped"] == 0
    assert (ours["html"] is None) == (ref["html"] is None) == (not html)
    _same_gallery(ours, ref, out, ref_out, 3)


def test_render_contract_matches_usip_tpu(exported, tmp_path):
    """The thresholds, the argument errors and the skipped count of frames
    with no bin."""
    assert render.SIGMA_THRESHOLDS == jax_render.SIGMA_THRESHOLDS
    cfg, jcfg = _cfgs()
    kp_dir = exported["bins"][3]
    for mod, c in ((render, cfg), (jax_render, jcfg)):
        with pytest.raises(ValueError, match="4-column"):
            mod.run_render(c, kp_dir, str(tmp_path / "x"), kp_dim=3,
                           sigma_threshold=0.3)
        with pytest.raises(ValueError, match="kp_dim"):
            mod.run_render(c, kp_dir, str(tmp_path / "x"), kp_dim=5)
    empty = str(tmp_path / "nobins")
    os.makedirs(empty)
    kw = dict(max_frames=4, html=False, synthetic=True)
    ours = render.run_render(cfg, empty, str(tmp_path / "a"), **kw)
    ref = jax_render.run_render(jcfg, empty, str(tmp_path / "b"), **kw)
    assert ours == ref == {"rendered": 0, "skipped": 16, "html": None}


def test_render_keypoints_command_matches_usip_tpu(exported, tmp_path,
                                                    capsys):
    args = ["render-keypoints", *FLAGS, "--synthetic", "--kp-dir",
            exported["bins"][4], "--kp-dim", "4", "--max-frames", "2",
            "--seed", "1"]
    out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    cli.main(args + ["--out", out])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(args + ["--out", ref_out])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["rendered"] == ref["rendered"] == 2
    _same_gallery(ours, ref, out, ref_out, 2)


def _clouds(tmp_path, n=2):
    folder = tmp_path / "clouds"
    folder.mkdir()
    rng = np.random.default_rng(3)
    for i in range(n):
        np.save(folder / f"c{i}.npy",
                rng.normal(size=(200, 6)).astype(np.float32))
    return str(folder)


def test_detect_render_html_matches_usip_tpu(exported, tmp_path, capsys):
    clouds = _clouds(tmp_path)
    out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    common = ["detect", *FLAGS, "--input", clouds, "--num-keypoints", "8",
              "--render", "--html"]
    cli.main(common + ["--checkpoint", exported["pth"], "--out", out,
                       "--device", "cpu"])
    ours = capsys.readouterr().out.strip().splitlines()
    jax_cli.main(common + ["--checkpoint", exported["msgpack"], "--out",
                           ref_out])
    ref = capsys.readouterr().out.strip().splitlines()
    assert ours[:-1] == ref[:-1] == ["c0: 8 keypoints", "c1: 8 keypoints"]
    assert _files(out) == _files(ref_out) == [
        "c0.keypoints.bin", "c0.png", "c1.keypoints.bin", "c1.png",
        "index.html"]
    assert _read(os.path.join(out, "index.html")) == _read(
        os.path.join(ref_out, "index.html"))
    for name in ("c0.png", "c1.png"):
        assert _png_size(os.path.join(out, name)) == _png_size(
            os.path.join(ref_out, name))
    # --render alone: the PNGs, no gallery
    solo = str(tmp_path / "solo")
    cli.main(["detect", *FLAGS, "--input", clouds, "--num-keypoints", "8",
              "--render", "--checkpoint", exported["pth"], "--out", solo,
              "--device", "cpu"])
    assert _files(solo) == ["c0.keypoints.bin", "c0.png",
                            "c1.keypoints.bin", "c1.png"]


def _no_matplotlib(monkeypatch):
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_without_matplotlib_the_renders_raise(exported, tmp_path,
                                              monkeypatch):
    clouds = _clouds(tmp_path)
    _no_matplotlib(monkeypatch)
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["render-keypoints", *FLAGS, "--synthetic", "--kp-dir",
                  exported["bins"][4], "--kp-dim", "4", "--out",
                  str(tmp_path / "g")])
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["detect", *FLAGS, "--input", clouds, "--render",
                  "--checkpoint", exported["pth"], "--out",
                  str(tmp_path / "d"), "--device", "cpu"])
    # without --render, detect needs no matplotlib
    cli.main(["detect", *FLAGS, "--input", clouds, "--checkpoint",
              exported["pth"], "--out", str(tmp_path / "plain"),
              "--device", "cpu"])
    assert _files(str(tmp_path / "plain")) == ["c0.keypoints.bin",
                                               "c1.keypoints.bin"]


def _engine(exported, tmp_path):
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    cfg = get_config("modelnet", **TINY)
    ds = SyntheticDataset(size=4, input_pc_num=128, surface_normal_len=3,
                          seed=0)
    engine = DetectorEngine(cfg, BatchLoader(ds, 4, num_workers=1), None,
                            out_dir=str(tmp_path / "run"), device="cpu")
    restore_checkpoint(exported["msgpack"], engine.state)
    return engine


@pytest.mark.parametrize("matplotlib", [True, False])
def test_snapshot_png_beside_the_npz(exported, tmp_path, monkeypatch,
                                     matplotlib):
    engine = _engine(exported, tmp_path)
    if not matplotlib:
        _no_matplotlib(monkeypatch)
    path = engine.snapshot_visuals(0)
    assert path.endswith(".npz") and os.path.exists(path)
    png = path.replace(".npz", ".png")
    if not matplotlib:
        assert not os.path.exists(png)
        return
    arrays = np.load(path)
    assert arrays["pc"].shape == (128, 3) and arrays["nodes"].shape == (16, 3)
    ref = str(tmp_path / "ref.png")
    jax_save_keypoint_scene(ref, arrays["pc"], arrays["nodes"],
                            arrays["keypoints"], arrays["sigmas"])
    assert _png_size(png) == _png_size(ref)
    assert _read(png) == _read(ref)
