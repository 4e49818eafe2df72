"""Detector training: the train state and the siamese train/eval steps."""

from usip_tpu_torch.train.state import (TrainState, lr_at_epoch, make_adam,
                                        set_learning_rate)
from usip_tpu_torch.train.steps import (DetectorBatch, DetectorDraws,
                                        ParentBatch, make_detector_eval_step,
                                        make_detector_loss_fn,
                                        make_detector_train_step)

__all__ = ["DetectorBatch", "DetectorDraws", "ParentBatch", "TrainState",
           "lr_at_epoch", "make_adam", "make_detector_eval_step",
           "make_detector_loss_fn", "make_detector_train_step",
           "set_learning_rate"]
