"""Port weights (usip_tpu_torch.weights) against usip_tpu's torch importer."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from usip_tpu.config import get_config
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.train.torch_import import (convert_detector_state_dict,
                                         export_detector_state_dict)
from usip_tpu_torch.models import Detector
from usip_tpu_torch.weights import (load_detector_weights, seeded_state_dict,
                                    state_dict_from_jax)

torch.set_num_threads(1)

CFG = get_config("kitti", **{"detector.c1": 16, "detector.c2": 32,
                             "detector.node_knn_k": 4})


def _jax_variables(seed=0):
    pc = jnp.zeros((1, 64, 3))
    sn = jnp.zeros((1, 64, CFG.detector.surface_normal_len))
    init = JaxDetector(CFG.detector).init(jax.random.PRNGKey(seed), pc, sn,
                                          pc[:, :16], train=False)
    return convert_detector_state_dict(seeded_state_dict(CFG.detector, seed),
                                       init)


def test_state_dict_from_jax_matches_export():
    """Key for key and value for value the same as usip_tpu's
    export_detector_state_dict, and it loads with strict=True."""
    variables = _jax_variables()
    ours = state_dict_from_jax(variables)
    ref = export_detector_state_dict(variables)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
        assert ours[k].shape == v.shape, k
    det = Detector(CFG.detector)
    result = det.load_state_dict(ours, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert "first_pointnet.layers.0.norm.num_batches_tracked" in \
        det.state_dict()


def test_load_detector_weights_pth_roundtrip(tmp_path):
    """A reference .pth, with the DataParallel 'module.' prefix, loads into
    the port with strict=True and reproduces every tensor."""
    sd = {k: torch.tensor(v) for k, v in
          seeded_state_dict(CFG.detector, 1).items()}
    path = tmp_path / "400_net_detector.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    det = Detector(CFG.detector)
    det.load_state_dict(load_detector_weights(str(path)), strict=True)
    for k, v in det.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_seeded_state_dict_is_nontrivial():
    """Seeded weights carry perturbed BatchNorm statistics and an mlp3 kernel
    far above the training init's N(0, 1e-4)."""
    sd = seeded_state_dict(CFG.detector, 2)
    assert np.abs(sd["mlp1.norm.running_mean"]).max() > 0
    assert not np.allclose(sd["mlp1.norm.running_var"], 1.0)
    assert not np.allclose(sd["knnlayer_1.layers_after.0.norm.weight"], 1.0)
    assert sd["mlp3.conv.weight"].std() > 1e-2
    np.testing.assert_array_equal(sd["mlp2.conv.weight"],
                                  seeded_state_dict(CFG.detector, 2)[
                                      "mlp2.conv.weight"])
