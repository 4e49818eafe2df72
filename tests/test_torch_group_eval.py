"""The grouped-trunk detectors' eval step and loss function, SOM with
k > 1 nodes a point (assignment and forward), a trained usip_tpu grouped
detector's weights in the port, and the Oxford entry points on a synthetic
Oxford tree, on the CPU (``torch_group_common`` holds the shared set-up;
the train steps are in ``test_torch_group_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu.ops import assign_points_to_nodes as jax_assign
from usip_tpu.train import steps as jsteps
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu_torch.config import get_config
from usip_tpu_torch.models import Detector
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import assign_points_to_nodes
from usip_tpu_torch.train import TrainState, steps
from usip_tpu_torch.train.checkpoint import restore_checkpoint
from usip_tpu_torch.train.loop import init_detector_state
from torch_group_common import (B, M, N, configs, jax_draws, make_setup,
                                port_names, som_configs, to_jax, to_torch)

torch.set_num_threads(1)


@pytest.mark.parametrize("grouping", ["knn", "ball"])
def test_group_eval_step_and_loss_fn_match_jax(grouping):
    """make_detector_eval_step (no augment, running statistics) and
    make_detector_loss_fn (the train data path, eval-mode BatchNorm,
    statistics untouched): metrics rel 1e-5, the loss function's gradients
    within 1e-5 x max|g|."""
    cfg, jcfg = configs(grouping)
    pc, sn, jmodel, variables, det = make_setup(cfg, jcfg, seed=2)
    key = jax.random.PRNGKey(13)
    jm = jax.jit(jsteps.make_detector_eval_step(jcfg, jmodel))(
        JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr)),
        jsteps.ParentBatch(pc=to_jax(pc), sn=to_jax(sn)), key)
    metrics = steps.make_detector_eval_step(cfg)(
        TrainState.create(det, cfg.train.lr),
        steps.ParentBatch(to_torch(pc), to_torch(sn)), draws=jax_draws(key, jcfg, False))
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

    batch = jsteps.DetectorBatch(to_jax(pc[:, :N]), to_jax(sn[:, :N]),
                                 to_jax(pc[:, -N:]), to_jax(sn[:, -N:]))
    (jl, jlm), jg = jax.jit(jax.value_and_grad(
        jsteps.make_detector_loss_fn(jcfg, jmodel), has_aux=True),
        static_argnums=4)(variables["params"], variables["batch_stats"],
                          batch, key, 0)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    loss, lm = steps.make_detector_loss_fn(cfg, det)(
        steps.DetectorBatch(*(to_torch(np.asarray(x)) for x in batch)), 0,
        draws=jax_draws(key, jcfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in jlm:
        np.testing.assert_allclose(float(lm[k]), float(jlm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    ref = port_names({"params": jg, "batch_stats": variables["batch_stats"]})
    gmax = max(float(ref[n].abs().max()) for n, _ in det.named_parameters())
    for name, p in det.named_parameters():
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-5 * gmax, (name, err, gmax)
    for k, v in det.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------- SOM, k > 1 ----

@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_som_assignment_k_matches_jax(k, bf16):
    """assign_points_to_nodes with k nearest nodes a point: ids (k-major),
    occupancy and counts identical to usip_tpu's, fp32 on random clouds
    (their order among equal distances included: nodes are cloud points,
    and some nodes repeat), bf16 on a 1/8 grid (exact distances, so the
    rounding to bf16 and its ties are the same in both)."""
    rng = np.random.default_rng(k)
    pc = rng.normal(0, 2, (B, N, 3)).astype(np.float32)
    if bf16:
        pc = np.round(pc * 8) / 8
    node = pc[:, rng.choice(N, M, replace=False)]
    node[:, 1] = node[:, 0]
    ref = jax_assign(to_jax(pc), to_jax(node), k=k,
                     compute_dtype=jnp.bfloat16 if bf16 else None)
    got = assign_points_to_nodes(to_torch(pc), to_torch(node), k=k, round_bf16=bf16)
    assert got.ids.shape == (B, k * N)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))


@pytest.mark.parametrize("k", [2, 3])
def test_som_k_forward_matches_jax(k):
    """The SOM detector with k nodes a point (the cloud stacked k times,
    k-major; cluster means, scatter-max and scatter-back over the kN
    stacked points), eval mode, fp32: anchors, keypoints and sigmas within
    1e-5 of usip_tpu's; the Detector no longer refuses k > 1."""
    cfg, jcfg = som_configs(k)
    pc, sn, jmodel, variables, det = make_setup(cfg, jcfg, seed=4)
    pc, sn = pc[:, :N], sn[:, :N]
    node = pc[:, ::N // M][:, :M]
    ref = jax.jit(jmodel.apply)(variables, to_jax(pc), to_jax(sn), to_jax(node))
    with torch.no_grad():
        out = det.eval()(to_torch(pc), to_torch(sn), to_torch(np.ascontiguousarray(node)))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------ weights ----

def test_trained_group_weights_restore_into_the_port(tmp_path):
    """A usip_tpu ball detector after two train steps (its BatchNorm
    statistics moved from the seeded ones): ``state_dict_from_jax`` of its
    variables, and its ``.msgpack`` through ``restore_checkpoint``, give
    the port usip_tpu's eval forward within 1e-5; the fused forward (the
    fusion layer on the chain's plain version, BatchNorm folded from the
    trained statistics) stays within the chain's bf16 error of it."""
    cfg, jcfg = configs("ball")
    pc, sn, jmodel, variables, _ = make_setup(cfg, jcfg, seed=6)
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    step = jax.jit(jsteps.make_detector_train_step(jcfg, jmodel))
    batch = jsteps.ParentBatch(pc=to_jax(pc), sn=to_jax(sn))
    for i in range(2):
        state, _ = step(state, batch, jax.random.PRNGKey(20 + i),
                        jnp.asarray(0))
    moved = jax.tree_util.tree_map(lambda a, b: float(jnp.abs(a - b).max()),
                                   state.batch_stats, variables["batch_stats"])
    assert max(jax.tree_util.tree_leaves(moved)) > 1e-3
    x, s = pc[:, :N], sn[:, :N]
    node = np.ascontiguousarray(x[:, ::N // M][:, :M])
    ref = jax.jit(jmodel.apply)(state.variables, to_jax(x), to_jax(s), to_jax(node))

    path = str(tmp_path / "best.msgpack")
    jax_save_checkpoint(path, state)
    from_vars = Detector(cfg.detector)
    from_vars.load_state_dict(port_names(state.variables), strict=True)
    port_state = init_detector_state(cfg, 0)
    restore_checkpoint(path, port_state)
    assert port_state.step == 2
    for det in (from_vars, port_state.model):
        with torch.no_grad():
            out = det.eval()(to_torch(x), to_torch(s), to_torch(node))
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
    fused = detector_infer_fused(port_state.model, to_torch(x), to_torch(s), to_torch(node))
    kp_ref = np.asarray(ref[1])
    err = np.abs(fused[1].numpy() - kp_ref).max() / np.abs(kp_ref).max()
    assert err <= 1e-2, err
    assert torch.equal(fused[0], to_torch(node))


# ------------------------------------------------------ Oxford tree ----

# the Oxford preset cut to the CPU: the ball detector of the released model
# at a small width, batch 2
TREE_OVERRIDES = ["data.input_pc_num=256", "data.parent_pc_num=320",
                  "data.node_num=16", "data.fps_subsample_ratio=2",
                  "detector.c1=16", "detector.c2=32", "detector.node_knn_k=4",
                  "detector.group_k=8", "detector.grouping=ball",
                  "train.log_every=1"]


def _last_json(out):
    import json
    return json.loads(out.strip().splitlines()[-1])


def test_oxford_tree_train_export_and_repeatability(tmp_path, capsys):
    """On a synthetic Oxford tree (``oxford_tree.build_oxford_tree``):
    its ground truth registers the test scans (the pos scan's points land
    on the anc scan's surfaces); ``train-detector --dataset oxford
    --override detector.grouping=ball --device cpu`` for 2 epochs, then
    ``--resume auto`` to a third; ``export-keypoints`` with the trained
    checkpoint, random keypoints and the ISS baseline; and
    ``eval-repeatability --oxford-root --coord-fix oxford`` on each."""
    from scipy.spatial import cKDTree

    from oxford_tree import build_oxford_tree
    from usip_tpu_torch import cli
    from usip_tpu_torch.data.eval_loaders import OxfordTestFrames
    from usip_tpu_torch.eval.eval_runner import load_oxford_gt_pkl
    from usip_tpu_torch.eval.repeatability import apply_transform

    root = str(tmp_path / "oxford")
    counts = build_oxford_tree(root, train_scans=8, test_scans=4, points=400,
                               spacing=2.0, scan_radius=15.0)
    assert counts == {"train": 8, "test": 4, "pairs": 3}
    gt = load_oxford_gt_pkl(root)
    folder = f"{root}/test_models_20k_np_nofilter"
    for row in gt:
        anc = np.load(f"{folder}/{row['anc_idx']}.npy")[:, :3]
        pos = np.load(f"{folder}/{row['pos_idx']}.npy")[:, :3]
        d, _ = cKDTree(anc).query(apply_transform(pos, row["T_gt"]))
        assert np.median(d) < 1.0, np.median(d)
    frames = OxfordTestFrames(get_config("oxford", **{
        "data.dataroot": root}).data)
    assert len(frames) == 4

    ckpt = str(tmp_path / "ckpt")
    base = ["train-detector", "--dataset", "oxford", "--dataroot", root,
            "--name", "ox", "--checkpoints-dir", ckpt, "--device", "cpu",
            "--batch-size", "2"]
    for kv in TREE_OVERRIDES:
        base += ["--override", kv]
    cli.main(base + ["--epochs", "2"])
    capsys.readouterr()
    cli.main(base + ["--epochs", "3", "--resume", "auto"])
    assert "at epoch 2" in capsys.readouterr().out
    import json
    with open(f"{ckpt}/ox/ox_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = {r["epoch"] for r in recs if r["prefix"] == "train_epoch"}
    assert epochs == {0, 1, 2}
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    with open(f"{ckpt}/ox/config.json") as f:
        saved = json.load(f)
    assert saved["detector"]["grouping"] == "ball"
    assert saved["augment"]["height_scale"] is True

    scores = {}
    for method in ("model", "random", "iss"):
        out = str(tmp_path / f"kp_{method}")
        argv = ["export-keypoints", "--dataset", "oxford", "--dataroot", root,
                "--out", out, "--method", method, "--device", "cpu",
                "--batch-size", "2", "--num-keypoints", "16"]
        if method == "model":
            argv += ["--checkpoint", f"{ckpt}/ox/last.pt"]
        for kv in TREE_OVERRIDES:
            argv += ["--override", kv]
        cli.main(argv)
        assert _last_json(capsys.readouterr().out)["frames"] == 4
        for i in range(4):
            kp = np.fromfile(f"{out}/00/{i}.bin", np.float32).reshape(-1, 3)
            assert kp.shape == (16, 3) and np.isfinite(kp).all()
        cli.main(["eval-repeatability", "--anc-dir", out, "--pos-dir", out,
                  "--oxford-root", root, "--coord-fix", "oxford"])
        line = _last_json(capsys.readouterr().out)
        assert line["pairs"] == 3 and 0.0 <= line["repeatability"] <= 1.0
        scores[method] = line["repeatability"]
    # the random keypoints of a pair repeat only by chance
    assert scores["random"] < 0.5, scores


def test_oxford_test_frames_count_and_gap(tmp_path):
    """``OxfordTestFrames`` counts the models on disk, and a gap in their
    numbering raises, as usip_tpu fails on the missing file."""
    from usip_tpu_torch.data.eval_loaders import OxfordTestFrames

    folder = tmp_path / "test_models_20k_np_nofilter"
    folder.mkdir()
    for i in (0, 1, 2):
        np.save(folder / f"{i}.npy", np.zeros((300, 8), np.float32))
    data = get_config("oxford", **{"data.dataroot": str(tmp_path)}).data
    assert len(OxfordTestFrames(data)) == 3
    (folder / "1.npy").rename(folder / "3.npy")
    with pytest.raises(FileNotFoundError, match="1.npy is missing"):
        OxfordTestFrames(data)
