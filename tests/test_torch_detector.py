"""Port detector (usip_tpu_torch.models) against usip_tpu.models.

Both sides load the same seeded weights (reference layout, perturbed
BatchNorm statistics, mlp3 scaled so that keypoints depend on the trunk) and
see the same numpy inputs and nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from usip_tpu.config import get_config
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.models.fused_infer import \
    detector_infer_fused as jax_detector_infer_fused
from usip_tpu.ops.pallas_kernels import (fused_fusion_chain,
                                         fusion_chain_params as
                                         jax_fusion_chain_params)
from usip_tpu.train.torch_import import convert_detector_state_dict
from usip_tpu_torch.models import Detector
from usip_tpu_torch.models.detector import knn_group
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.weights import seeded_state_dict

torch.set_num_threads(1)

B, N, M, S = 2, 512, 128, 4
CFG = get_config("kitti", **{"detector.c1": 16, "detector.c2": 32,
                             "detector.node_knn_k": 4,
                             "detector.compute_dtype": "float32"})


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(B, N, 3)).astype(np.float32)
    sn = rng.normal(size=(B, N, S)).astype(np.float32)
    sel = np.stack([rng.choice(N, M, replace=False) for _ in range(B)])
    node = np.take_along_axis(pc, sel[..., None], axis=1)
    sd = seeded_state_dict(CFG.detector, seed)
    jax_model = JaxDetector(CFG.detector)
    init = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]),
                          jnp.asarray(sn[:1]), jnp.asarray(node[:1]),
                          train=False)
    variables = convert_detector_state_dict(sd, init)
    det = Detector(CFG.detector)
    det.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                        strict=True)
    return pc, sn, node, jax_model, variables, det.eval()


def _np(*ts):
    return [np.asarray(t) for t in ts]


def test_fusion_chain_plain_matches_pallas():
    """Plain fused chain against fused_fusion_chain (interpret mode) on the
    same folded weights: max |diff| <= 1e-2 * max|ref| and median <= 1e-3 *
    max|ref| (bf16 operands; fp32 sums in another order can flip a bf16
    rounding of an intermediate activation)."""
    pc, sn, node, _, variables, det = _setup(1)
    ws, bs = kernels.fusion_chain_params(det.knnlayer_1)
    jws, jbs = jax_fusion_chain_params(variables["params"]["knnlayer"],
                                       variables["batch_stats"]["knnlayer"])
    for a, b in zip(ws + bs, jws + jbs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    rng = np.random.default_rng(2)
    grouped = rng.normal(size=(B, M, 4, 3 + CFG.detector.c1)).astype(
        np.float32)
    ref = np.asarray(fused_fusion_chain(jnp.asarray(grouped), jws, jbs,
                                        tile_m=128, interpret=True))
    out = kernels.fusion_chain(torch.from_numpy(grouped), ws, bs).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(out - ref)
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert np.median(err) <= 1e-3 * scale, (np.median(err), scale)


def test_layered_detector_fp32_matches_jax():
    """The port's layered Detector in fp32 against Detector.apply
    (train=False, compute_dtype float32): anchors, keypoints and sigmas
    within 1e-4."""
    pc, sn, node, jax_model, variables, det = _setup(3)
    ref = _np(*jax_model.apply(variables, jnp.asarray(pc), jnp.asarray(sn),
                               jnp.asarray(node), train=False))
    with torch.no_grad():
        out = det(torch.from_numpy(pc), torch.from_numpy(sn),
                  torch.from_numpy(node))
    # the keypoints really depend on the trunk, not only on the anchors
    assert np.abs(ref[1] - ref[0]).max() > 1e-2
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=0)


def test_fused_infer_matches_jax_fused():
    """The port's detector_infer_fused against usip_tpu's (interpret mode):
    anchors within 1e-4; keypoints and sigmas within 2e-2 * max|ref|, median
    within 2e-3 * max|ref| (the fused chain's bf16 operands)."""
    pc, sn, node, _, variables, det = _setup(4)
    ref = _np(*jax_detector_infer_fused(CFG, variables, jnp.asarray(pc),
                                        jnp.asarray(sn), jnp.asarray(node),
                                        interpret=True))
    out = [t.numpy() for t in detector_infer_fused(
        det, torch.from_numpy(pc), torch.from_numpy(sn),
        torch.from_numpy(node))]
    np.testing.assert_allclose(out[0], ref[0], atol=1e-4, rtol=0)
    for o, r in zip(out[1:], ref[1:]):
        scale = np.abs(r).max()
        err = np.abs(o - r)
        assert err.max() <= 2e-2 * scale, (err.max(), scale)
        assert np.median(err) <= 2e-3 * scale, (np.median(err), scale)


def test_knn_group_matches_layered_input():
    """The fused path's grouped input is the layered module's: the chain on
    it equals the layered fusion stack up to the chain's bf16 operands."""
    pc, sn, node, _, _, det = _setup(5)
    with torch.no_grad():
        anchors, feat = det.som_trunk(torch.from_numpy(pc),
                                      torch.from_numpy(sn),
                                      torch.from_numpy(node))
        layered = det.knnlayer_1(anchors, anchors, feat).numpy()
        grouped = knn_group(anchors, anchors, feat, CFG.detector.node_knn_k)
        fused = kernels.fusion_chain(grouped, *kernels.fusion_chain_params(
            det.knnlayer_1)).numpy()
    scale = np.abs(layered).max()
    assert np.abs(fused - layered).max() <= 2e-2 * scale
